// atmos_march: the preview's single-scatter march, one thread per lane.
//
// Replaces the loop nest of digital_earth_tpu/render/raymarcher.py:56
// _ray_march_atmos (a 64-step lax.fori_loop) with its nested :34
// _ray_march_transmittance (a 16-step fori_loop toward the sampled sun
// direction, with its planet-occlusion test and a_far < 0 -> t_max = -1).
// Per lane it computes what the reference computes: per step the RMO
// density at the sample, the step's optical depth and transmittance, the
// visible share of the step, the sun transmittance from the sample, and the
// Rayleigh + Mie in-scatter; positions advance by repeated addition as the
// reference's carry does, and species sum in the order (0, 1, 2).
//
// What bounds it on the H100: arithmetic on the special-function units.
// Each lane evaluates the three density profiles 64 x 17 times (about five
// expf each) and touches memory only to load its 17 inputs and store two
// outputs, so there is nothing to tile or stage. A lane whose sun ray is
// occluded by the planet skips its 16 transmittance steps (the reference
// multiplies their result by zero). Lanes that are not active return
// (0, 1); march_paths masks both outputs by the same mask.
#include <cstdint>

#include <cuda_runtime.h>

#include "atmosphere.cuh"

namespace de {

constexpr int ATMOS_MARCH_STEPS = 64;
constexpr int SUN_TRANS_STEPS = 16;

struct PhaseConsts {
  float rayl_k;    // 3 / (16 pi)
  float mie_e;     // Klein-Nishina e
  float two_pi;
  float log_term;  // log(2 e + 1), as float32
};

__device__ __forceinline__ float elevation(V3 p) { return sqrtf(dot(p, p)) - PLANET_R_F; }

__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ float sun_transmittance(V3 pos, V3 sd, const float ext[3]) {
  float p_near, p_far;
  rsi(pos, sd, PLANET_R_F, p_near, p_far);
  if (p_far > 0.0f) return 0.0f;  // occluded by the planet
  float a_near, a_far;
  rsi(pos, sd, ATMOS_UPPER_F, a_near, a_far);
  const float t_max = a_far < 0.0f ? -1.0f : a_far;
  const float dd = t_max / (float)SUN_TRANS_STEPS;
  float od0 = 0.0f, od1 = 0.0f, od2 = 0.0f;
  V3 p = pos;
  for (int i = 0; i < SUN_TRANS_STEPS; ++i) {
    float dens[3];
    get_density(elevation(p), dens);
    od0 = od0 + dens[0] * dd;
    od1 = od1 + dens[1] * dd;
    od2 = od2 + dens[2] * dd;
    p = along(p, dd, sd);
  }
  return expf(-(ext[0] * od0 + ext[1] * od1 + ext[2] * od2));
}

__global__ void atmos_march_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ dir,
                                   const float* __restrict__ t_start,
                                   const float* __restrict__ t_max,
                                   const float* __restrict__ sun_dir,
                                   const float* __restrict__ ext_rmo,
                                   const float* __restrict__ scattering,
                                   const uint8_t* __restrict__ active,
                                   float* __restrict__ in_scatter_out,
                                   float* __restrict__ trans_out, int n,
                                   PhaseConsts pc) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  if (!active[lane]) {
    in_scatter_out[lane] = 0.0f;
    trans_out[lane] = 1.0f;
    return;
  }
  const V3 o = load3(pos, lane), d = load3(dir, lane), sd = load3(sun_dir, lane);
  const float ext[3] = {ext_rmo[3 * lane], ext_rmo[3 * lane + 1], ext_rmo[3 * lane + 2]};
  const float sc0 = scattering[2 * lane], sc1 = scattering[2 * lane + 1];
  const float ts = t_start[lane];
  const float dd = (t_max[lane] - ts) / (float)ATMOS_MARCH_STEPS;

  const float c = dot(d, sd);
  const float phase0 = pc.rayl_k * (1.0f + c * c);
  const float phase1 =
      pc.mie_e / (pc.two_pi * (pc.mie_e * (1.0f - c) + 1.0f) * pc.log_term);

  float in_scatter = 0.0f, trans = 1.0f;
  V3 p = along(o, ts, d);
  for (int i = 0; i < ATMOS_MARCH_STEPS; ++i) {
    float dens[3];
    get_density(elevation(p), dens);
    const float step_od = ext[0] * dens[0] * dd + ext[1] * dens[1] * dd + ext[2] * dens[2] * dd;
    const float step_trans = saturate(expf(-step_od));
    const float step_integral = saturate((1.0f - step_trans) / fmaxf(step_od, 1e-8f));
    const float visible = trans * step_integral;
    const float sun_trans = sun_transmittance(p, sd, ext);
    const float step_scatter = sc0 * dens[0] * phase0 + sc1 * dens[1] * phase1;
    in_scatter = in_scatter + step_scatter * sun_trans * visible * dd;
    trans = trans * step_trans;
    p = along(p, dd, d);
  }
  in_scatter_out[lane] = in_scatter;
  trans_out[lane] = trans;
}

}  // namespace de

extern "C" int de_atmos_march(const float* pos, const float* dir, const float* t_start,
                              const float* t_max, const float* sun_dir,
                              const float* ext_rmo, const float* scattering,
                              const uint8_t* active, float* in_scatter, float* trans,
                              int n, float rayl_k, float mie_e, float two_pi,
                              float log_term, void* stream) {
  const de::PhaseConsts pc{rayl_k, mie_e, two_pi, log_term};
  const int block = 128;
  de::atmos_march_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      pos, dir, t_start, t_max, sun_dir, ext_rmo, scattering, active, in_scatter, trans,
      n, pc);
  return (int)cudaGetLastError();
}
