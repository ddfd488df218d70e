// land_march: the displaced-sphere land march with the reference's phantom
// crawl, one thread per lane.
//
// Replaces the TPU loop digital_earth_tpu/render/pathtracer.py:211
// intersect_land (masked lax.while_loop at :301-333, K probes per
// iteration) and :515 _phantom_crawl (the h = 0 crawl loop at :573). Per
// lane it computes what that loop computes: bounding-sphere cull and
// bracket, K probes at the lane's stride, the three regional max-mip skips
// (25/115/8 km), the texel-arc step floor, negative-SDF backtrack, the exact
// ocean root, stall termination, the t_cap, the any-hit mode and the probe
// budget; probes after the first stopping one do not change the result, so
// a thread stops its sweep there.
//
// What bounds it on the H100: latency and divergence, not bandwidth. Each
// probe is one dependent 4-byte texture read and a few dozen flops, and a
// warp runs until its slowest lane has finished (budget 250 probes, most
// lanes stop within ~8). This first version keeps the loop simple; lane
// regrouping by expected trip count and texture-cache reads are later work.
#include <cstdint>

#include <cuda_runtime.h>

#include "atmosphere.cuh"
#include "texture.cuh"

namespace de {

struct MarchParams {
  int H, W;
  float scale, step_floor, stall_thresh;
  int steps, k, patience, any_hit;
};

__global__ void land_march_kernel(const uint8_t* __restrict__ topo,
                                  const float* __restrict__ pos,
                                  const float* __restrict__ dir,
                                  const uint8_t* __restrict__ active,
                                  const float* __restrict__ t_cap,
                                  float* __restrict__ out, int n, MarchParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const V3 o = load3(pos, lane), d = load3(dir, lane);
  const bool act = active[lane] != 0;
  const float cap = t_cap[lane];
  const float valid3[3] = {25e3f, 115e3f, 8e3f};

  float bound_near, bound_far;
  rsi(o, d, PLANET_R_F + p.scale, bound_near, bound_far);
  bool may_hit = act && (bound_far > 0.0f);
  const float t0 = fmaxf(bound_near, 0.0f);
  const float miss_beyond = fminf(fminf(bound_far + 1.0f, MAX_RAY_DIST_F), cap);
  may_hit = may_hit && (t0 < cap);

  float t = t0, stride = p.step_floor;
  bool done = !may_hit, missed = !may_hit;
  int stall = 0;
  for (int i = 0; i < p.steps && !done; i += p.k) {
    bool any_stop = false, conv_stop = false, out_stop = false;
    float t_stop = 0.0f, step_stop = 0.0f, ts_last = 0.0f, step_last = 0.0f;
    for (int j = 0; j < p.k; ++j) {
      const float ts = t + (float)j * stride;
      const V3 ro = along(o, ts, d);
      float s[4];
      sphere_tap_nearest<4>(topo, p.H, p.W, ro, s);
      const float b = dot(ro, d);
      const V3 cr = cross(ro, d);
      const float h2b = dot(cr, cr);
      const float rlen = sqrtf(dot(ro, ro));
      const float f = (rlen - PLANET_R_F) - p.scale * s[0];

      const float pdisc = PLANET_R_F * PLANET_R_F - h2b;
      const float p_near = pdisc < 0.0f ? -1.0f : -b - sqrtf(fmaxf(pdisc, 0.0f));
      float s_region = 0.0f;
      bool ocean_hit = false;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float mip = s[1 + m];
        const float r_bound = PLANET_R_F + p.scale * mip;
        const float disc = r_bound * r_bound - h2b;
        const float sqd = sqrtf(fmaxf(disc, 0.0f));
        const bool miss = disc < 0.0f;
        const float near_ = miss ? -1.0f : -b - sqd;
        const float far_ = miss ? -1.0f : -b + sqd;
        const float skip = near_ > 0.0f ? fminf(near_, valid3[m])
                         : (far_ < 0.0f ? valid3[m] : 0.0f);
        s_region = m == 0 ? skip : fmaxf(s_region, skip);
        ocean_hit = ocean_hit || ((mip <= 0.0f) && (p_near > 0.0f) && (p_near <= valid3[m]));
      }
      const float step = f < 0.0f ? f : fmaxf(fmaxf(f, s_region), p.step_floor);
      bool converged = fabsf(f) < ts * 1e-4f;
      float t_conv = converged ? ts : ts + p_near;
      converged = converged || ocean_hit;
      if (p.any_hit && f < 0.0f) {
        converged = true;
        t_conv = ts;
      }
      const bool out_ = ts > miss_beyond;
      ts_last = ts;
      step_last = step;
      if (converged || out_ || step < stride) {
        any_stop = true;
        t_stop = converged ? t_conv : ts;
        step_stop = step;
        conv_stop = converged;
        out_stop = out_;
        break;
      }
    }
    float t_new, applied;
    if (any_stop) {
      t_new = (conv_stop || out_stop) ? t_stop : t_stop + step_stop;
      applied = step_stop;
    } else {
      t_new = ts_last + step_last;
      applied = step_last;
    }
    const float stride_new = fmaxf(applied, p.step_floor);
    const bool newly_done = any_stop && (conv_stop || out_stop);
    if (any_stop && out_stop && !conv_stop) missed = true;
    const float t_next = newly_done ? t_stop : t_new;
    const bool stalled_now = !newly_done && (t_next - t < p.stall_thresh);
    stall = stalled_now ? stall + 1 : 0;
    const bool stuck = stall >= p.patience;
    if (!(newly_done || stuck)) stride = stride_new;
    done = newly_done || stuck;
    t = t_next;
  }
  float result = (!missed && t < MAX_RAY_DIST_F) ? t : -1.0f;

  {  // phantom crawl
    const float b0 = dot(o, d);
    const V3 cr = cross(o, d);
    const float h2 = dot(cr, cr);
    float a_near, a_far;
    rsi(o, d, ATMOS_UPPER_F, a_near, a_far);
    const float perigee_alt = sqrtf(h2) - PLANET_R_F;
    if (act && result < 0.0f && perigee_alt < 16e3f) {
      float tp = a_near > 0.0f ? a_near : 0.0f;
      bool pdone = false;
      for (int i = 0; i < p.steps && !pdone; i += 8) {
        for (int s = 0; s < 8 && !pdone; ++s) {
          const float bb = b0 + tp;
          const float dist = sqrtf(h2 + bb * bb) - PLANET_R_F;
          const float t_new = tp + dist;
          pdone = (t_new > MAX_RAY_DIST_F) || (fabsf(dist) < t_new * 1e-4f);
          tp = t_new;
        }
      }
      if (tp < MAX_RAY_DIST_F && tp < cap) result = tp;
    }
  }
  out[lane] = result;
}

}  // namespace de

extern "C" int de_land_march(const uint8_t* topo, int H, int W, const float* pos,
                             const float* dir, const uint8_t* active,
                             const float* t_cap, float* out, int n, float scale,
                             float step_floor, float stall_thresh, int steps,
                             int k, int patience, int any_hit, void* stream) {
  const de::MarchParams p{H, W, scale, step_floor, stall_thresh, steps, k,
                          patience, any_hit};
  const int block = 128;
  de::land_march_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      topo, pos, dir, active, t_cap, out, n, p);
  return (int)cudaGetLastError();
}
