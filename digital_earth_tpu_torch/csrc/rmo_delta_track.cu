// rmo_delta_track: Woodcock (delta) tracking of a free-flight event through
// the Rayleigh / Mie / ozone gases, one thread per lane.
//
// Replaces the TPU loop digital_earth_tpu/render/pathtracer.py:631
// _delta_track_rmo (masked lax.while_loop, K speculative steps per
// iteration). Per lane and iteration i it draws the reference's threefry
// stream uniform(fold(key, i), (3, K)), rebuilds the local hero majorant
// from the density envelope at the minimum radius of the remaining segment,
// takes K exponential steps (prefix sums in the reference's sequential
// order), and resolves the first probe that is real or past t_max: species
// by the hero extinction CMF, scatter vs absorb by albedo roulette. Cap
// max_steps iterations.
//
// What bounds it on the H100: latency and divergence. No memory is read in
// the loop (the densities are analytic); each iteration is ~13 threefry
// blocks plus K exp/log evaluations, and a warp runs until its slowest lane
// stops, so the cost is the worst lane's iteration count per warp.
#include <cstdint>

#include <cuda_runtime.h>

#include "atmosphere.cuh"
#include "threefry.cuh"

namespace de {

__global__ void rmo_delta_track_kernel(
    const int32_t* __restrict__ keys, const float* __restrict__ pos,
    const float* __restrict__ dir, const float* __restrict__ t_start,
    const float* __restrict__ t_max, const float* __restrict__ ext_h,
    const uint8_t* __restrict__ active, int32_t* __restrict__ event_out,
    float* __restrict__ t_out, int32_t* __restrict__ iid_out, int n,
    int max_steps, int k, float o3_env_peak) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float albedo[3] = {1.0f, 0.95f, 0.0f};
  const Key key = load_key(keys, lane);
  const V3 o = load3(pos, lane), d = load3(dir, lane);
  const float e0 = ext_h[3 * lane], e1 = ext_h[3 * lane + 1], e2 = ext_h[3 * lane + 2];
  const float tm = t_max[lane];
  float t = t_start[lane];
  const bool valid = (active[lane] != 0) && (tm >= 0.0f) && (t < tm);
  const float tms = fmaxf(tm, 0.0f);
  const float rp = perigee_radius(o, d);
  const float xp = dot(o, d);
  const float x_end = tms + xp;

  int event = 0, iid = 0;
  bool done = !valid;
  for (int i = 0; i < max_steps && !done; ++i) {
    const Key ki = fold(key, (uint32_t)i);
    const float r_min = segment_min_radius(rp, t + xp, x_end);
    float env[3];
    density_envelope(r_min - PLANET_R_F, o3_env_peak, env);
    const float inv_max = 1.0f / fmaxf(dot3(e0, e1, e2, env[0], env[1], env[2]), 1e-20f);
    float cs = 0.0f, ts = t;
    for (int j = 0; j < k; ++j) {
      const float u0 = uniform(ki, (uint32_t)j);
      const float step = -logf(fmaxf(u0, 1e-12f)) * inv_max;
      cs = j == 0 ? step : cs + step;
      ts = t + cs;
      const V3 p = along(o, fminf(ts, tms), d);
      float dens[3];
      get_density(sqrtf(dot(p, p)) - PLANET_R_F, dens);
      const float total = dot3(dens[0], dens[1], dens[2], e0, e1, e2);
      const bool over = ts >= tm;
      const float u1 = uniform(ki, (uint32_t)(k + j));
      if (over || u1 < total * inv_max) {
        if (!over) {
          const float r = u1 / inv_max;
          const float c0 = dens[0] * e0;
          const float c01 = c0 + dens[1] * e1;
          const int id = r < c0 ? 0 : (r < c01 ? 1 : 2);
          const float u2 = uniform(ki, (uint32_t)(2 * k + j));
          event = u2 < albedo[id] ? 2 : 1;
          iid = id;
        }
        done = true;
        break;
      }
    }
    t = ts;
  }
  event_out[lane] = event;
  t_out[lane] = t;
  iid_out[lane] = iid;
}

}  // namespace de

extern "C" int de_rmo_delta_track(const int32_t* keys, const float* pos,
                                  const float* dir, const float* t_start,
                                  const float* t_max, const float* ext_h,
                                  const uint8_t* active, int32_t* event,
                                  float* t, int32_t* iid, int n, int max_steps,
                                  int k, float o3_env_peak, void* stream) {
  const int block = 128;
  de::rmo_delta_track_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      keys, pos, dir, t_start, t_max, ext_h, active, event, t, iid, n,
      max_steps, k, o3_env_peak);
  return (int)cudaGetLastError();
}
