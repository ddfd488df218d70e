// The preview's single-scatter march, as a warp-cooperative device function:
// the body of the atmos_march kernel (atmos_march.cu) and of the preview
// kernel's marches (preview.cu).
//
// Per lane it computes what the TPU loop nest digital_earth_tpu/render/
// raymarcher.py:56 _ray_march_atmos (a 64-step lax.fori_loop) with its
// nested :34 _ray_march_transmittance (a 16-step fori_loop toward the sampled
// sun direction, with its planet-occlusion test and a_far < 0 -> t_max = -1)
// computes: per step the RMO density at the sample, the step's optical depth
// and transmittance, the visible share of the step, the sun transmittance
// from the sample, and the Rayleigh + Mie in-scatter; positions advance by
// repeated addition as the reference's carry does, and species sum in the
// order (0, 1, 2). A step whose sun ray the planet occludes skips its 16
// transmittance steps (the reference multiplies their result by zero).
#pragma once

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

// The sun transmittance from J march steps' positions toward sd, their 16
// steps interleaved so that J independent density chains are in flight in
// one thread. Each step's sums run in its own order, so each result has the
// bits of one step's march alone; a step whose sun ray the planet occludes
// gets 0 (its 16 steps are computed and dropped, as the reference drops
// them by multiplying by zero).
template <int J>
__device__ __forceinline__ void sun_transmittance(const V3 (&pos)[J], V3 sd, const float ext[3],
                                                  float (&out)[J]) {
  V3 p[J];
  float dd[J], od0[J], od1[J], od2[J];
  bool lit[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float p_near, p_far, a_near, a_far;
    rsi(pos[j], sd, PLANET_R_F, p_near, p_far);
    lit[j] = !(p_far > 0.0f);
    rsi(pos[j], sd, ATMOS_UPPER_F, a_near, a_far);
    const float t_max = a_far < 0.0f ? -1.0f : a_far;
    dd[j] = t_max / (float)SUN_TRANS_STEPS;
    od0[j] = od1[j] = od2[j] = 0.0f;
    p[j] = pos[j];
  }
  for (int i = 0; i < SUN_TRANS_STEPS; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float dens[3];
      get_density(elevation(p[j]), dens);
      od0[j] = od0[j] + dens[0] * dd[j];
      od1[j] = od1[j] + dens[1] * dd[j];
      od2[j] = od2[j] + dens[2] * dd[j];
      p[j] = along(p[j], dd[j], sd);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
    out[j] = lit[j] ? expf(-(ext[0] * od0[j] + ext[1] * od1[j] + ext[2] * od2[j])) : 0.0f;
}

// The 64-step march of the ray o + t d over [ts, tm] toward the sun
// direction sd, warp-cooperative: (in_scatter, transmittance) of each
// ``active`` lane of the warp; every thread of the warp must call it (it
// shuffles across the full warp), active or not, and an inactive lane's
// outputs are left as they were. ext holds a lane's RMO extinctions, sc0
// and sc1 its Rayleigh and Mie scattering.
//
// The 64 steps depend on one another only through three cheap serial
// chains: the position (repeated addition, p = p + dd d), the
// transmittance product and the in-scatter sum. Everything else of a step,
// the density, its optical depth, transmittance and visible share, the
// 16-step sun march (about 94% of the work) and the scatter term, depends
// on the step's position alone. So the warp takes its active lanes, the
// segments, 32 / S at a time: S threads share a segment, each computing
// 64 / S consecutive steps' terms, its first position walked by the same
// repeated addition from the segment's start (a position taken as
// t_start + i dd would round otherwise), the sun marches of up to four of
// its steps interleaved (the march is latency-bound: a frame's active lanes
// fill about 12 warps per SM, and one density chain leaves most issue
// slots empty); then every thread of the group
// folds the 64 terms in step order, fetched by __shfl_sync, rounding
// visible = trans * integral, the in-scatter sum and the transmittance
// product op by op as the per-lane march does, and the segment's lane
// takes the result from its group. The same operations on the same
// operands in the same order: the bits of one thread marching alone. A
// warp pays (its active lanes, rounded up to 32 / S) x 64 / S step times
// where one thread per lane paid 64 step times of its slowest lane.
// S = 16 threads to a segment: measured on the H100 against 8 and 32 (PERF.md
// §6), the fastest of the three on the preview's frame.
constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int MARCH_SPLIT = 16;

__device__ __forceinline__ void atmos_march_warp(bool active, V3 o, V3 d, float ts, float tm,
                                                 V3 sd, const float ext[3], float sc0, float sc1,
                                                 PhaseConsts pc, float& in_scatter_out,
                                                 float& trans_out) {
  constexpr int S = MARCH_SPLIT;
  static_assert(S >= 1 && S <= 32 && 32 % S == 0 && ATMOS_MARCH_STEPS % S == 0, "split");
  constexpr int K = ATMOS_MARCH_STEPS / S;  // steps per thread
  constexpr int G = 32 / S;                 // segments per round
  constexpr int J = K < 4 ? K : 4;          // steps whose sun marches interleave
  const int lane = threadIdx.x & 31;
  const int grp = lane / S, sub = lane % S;
  unsigned pending = __ballot_sync(FULL_WARP, active);
  while (pending) {  // warp-uniform
    // this round's segments: the G lowest pending lanes, group g taking the g-th
    int owner = -1, mine = -1;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int l = pending ? __ffs(pending) - 1 : -1;
      if (g == grp) owner = l;
      if (l == lane) mine = g;
      pending &= pending - 1;
    }
    const int src = owner >= 0 ? owner : lane;
    const V3 so{__shfl_sync(FULL_WARP, o.x, src), __shfl_sync(FULL_WARP, o.y, src),
                __shfl_sync(FULL_WARP, o.z, src)};
    const V3 sdir{__shfl_sync(FULL_WARP, d.x, src), __shfl_sync(FULL_WARP, d.y, src),
                  __shfl_sync(FULL_WARP, d.z, src)};
    const V3 ssun{__shfl_sync(FULL_WARP, sd.x, src), __shfl_sync(FULL_WARP, sd.y, src),
                  __shfl_sync(FULL_WARP, sd.z, src)};
    const float sts = __shfl_sync(FULL_WARP, ts, src), stm = __shfl_sync(FULL_WARP, tm, src);
    const float sext[3] = {__shfl_sync(FULL_WARP, ext[0], src),
                           __shfl_sync(FULL_WARP, ext[1], src),
                           __shfl_sync(FULL_WARP, ext[2], src)};
    const float ssc0 = __shfl_sync(FULL_WARP, sc0, src), ssc1 = __shfl_sync(FULL_WARP, sc1, src);

    const float dd = (stm - sts) / (float)ATMOS_MARCH_STEPS;
    float st[K], si[K], sa[K];  // per step: step_trans, step_integral, scatter x sun_trans
    if (owner >= 0) {
      const float c = dot(sdir, ssun);
      const float phase0 = pc.rayl_k * (1.0f + c * c);
      const float phase1 =
          pc.mie_e / (pc.two_pi * (pc.mie_e * (1.0f - c) + 1.0f) * pc.log_term);
      V3 p = along(so, sts, sdir);
      for (int i = 0; i < sub * K; ++i) p = along(p, dd, sdir);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += J) {
        V3 ps[J];
        float scatter[J], sun[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = k0 + j;
          float dens[3];
          get_density(elevation(p), dens);
          const float step_od =
              sext[0] * dens[0] * dd + sext[1] * dens[1] * dd + sext[2] * dens[2] * dd;
          st[k] = saturate(expf(-step_od));
          si[k] = saturate((1.0f - st[k]) / fmaxf(step_od, 1e-8f));
          scatter[j] = ssc0 * dens[0] * phase0 + ssc1 * dens[1] * phase1;
          ps[j] = p;
          p = along(p, dd, sdir);
        }
        sun_transmittance<J>(ps, ssun, sext, sun);
#pragma unroll
        for (int j = 0; j < J; ++j) sa[k0 + j] = scatter[j] * sun[j];
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) st[k] = si[k] = sa[k] = 0.0f;
    }
    // the fold, in step order: step j * K + k lies in sub-thread j's slot k
    float in_scatter = 0.0f, trans = 1.0f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float step_trans = __shfl_sync(FULL_WARP, st[k], j, S);
        const float step_integral = __shfl_sync(FULL_WARP, si[k], j, S);
        const float scatter_sun = __shfl_sync(FULL_WARP, sa[k], j, S);
        const float visible = trans * step_integral;
        in_scatter = in_scatter + scatter_sun * visible * dd;
        trans = trans * step_trans;
      }
    }
    const int from = mine >= 0 ? mine * S : lane;
    const float r_in = __shfl_sync(FULL_WARP, in_scatter, from);
    const float r_tr = __shfl_sync(FULL_WARP, trans, from);
    if (mine >= 0) {
      in_scatter_out = r_in;
      trans_out = r_tr;
    }
  }
}

}  // namespace de
