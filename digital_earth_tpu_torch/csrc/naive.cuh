// The reference-faithful naive arm as device functions, one thread a lane
// running the reference renderer's own loop: the body of the naive_march and
// naive_track launchers (naive_march.cu, naive_track.cu) and of the bounce
// entries' options instances under TraceConfig.naive_tracking, naive_march,
// naive_cloud_tracking and naive_shadow (bounce.cuh).
//
// Replaces the TPU loops of digital_earth_tpu/render/tracking_naive.py:
//   - naive_march_lane   <- :31 intersect_land_naive: an RSI warm start on
//     the atmosphere shell, then up to land_march_steps steps of the signed
//     SDF (length - R - scale h, one tap of the topography's channel 0),
//     stopping at |dist| < 1e-4 of the distance or past ten planet radii; a
//     hit if the distance ends under that cap. No cap, any-hit mode, mips,
//     floor, ocean root, stall patience or phantom crawl;
//   - naive_delta_lane   <- :72 delta_track_naive: a step at the global
//     majorant from the draws uniform(fold(key, i), (3,)), the species'
//     densities at the step (the gases' analytic profile, or the cloud map's
//     channel 0 and the split shape), the event by u1 < total / majorant, the
//     gas by the cumulative terms at r = u1 * majorant and scatter vs absorb
//     by the albedo table;
//   - naive_ratio_lane   <- :126 ratio_track_naive for the cloud: one draw
//     a step, the transmittance times 1 - total / majorant, a stop past t_max
//     or below 1e-5. For the gases the same loop is rmo_track.cuh's
//     rmo_ratio_lane at one wavelength and one probe an iteration (the same
//     draw, step, density sum and stops, bit for bit), which the launcher
//     and the bounce run.
// Each step rounds as the plain twins in render/tracking_naive.py do on the
// card (a species' total summed left to right; --fmad=false), with draws
// from threefry.cuh bit for bit and taps from texture.cuh (sphere_tap, the
// twin's sample_sphere_texture). A draw the step does not read is not made.
//
// What bounds them on the H100: latency and divergence. A step is a few
// dozen operations, one threefry block per draw and, for the march and the
// cloud species, one dependent texture read; a lane's steps are a dependent
// chain of up to max_tracking_steps (land_march_steps for the march), the
// cloud's at the global majorant (345 m a step at bounce 0-9), and a warp
// runs at its longest lane. These loops are the reference's semantics, kept
// simple: the accelerated loops are the fast ones.
#pragma once
#include <cstdint>

#include "atmosphere.cuh"
#include "cloud_track.cuh"
#include "texture.cuh"
#include "threefry.cuh"

namespace de {

enum { NAIVE_RMO = 0, NAIVE_CLOUD = 1 };

// The plain march's hit distance (-1 on a miss or for an inactive lane);
// ``iters``, if set, gets the lane's steps.
__device__ __forceinline__ float naive_march_lane(const uint8_t* __restrict__ topo, int H, int W,
                                                  float scale, int steps, bool bilinear, V3 o,
                                                  V3 d, bool active, int* iters = nullptr) {
  float a_near, a_far;
  rsi(o, d, ATMOS_UPPER_F, a_near, a_far);
  float t = a_near > 0.0f ? a_near : 0.0f;
  bool done = !active;
  int it = 0;
  for (int i = 0; i < steps && !done; ++i) {
    ++it;
    const V3 ro = along(o, t, d);
    float s[4];
    sphere_tap<4>(topo, H, W, ro, bilinear, s);
    const float dist = (length(ro) - PLANET_R_F) - scale * s[0];
    const float t_new = t + dist;
    done = (t_new > MAX_RAY_DIST_F) || (fabsf(dist) < t_new * 1e-4f);
    t = t_new;
  }
  if (iters) *iters = it;
  return active && t < MAX_RAY_DIST_F ? t : -1.0f;
}

// The split-shape slab density (render/tracers.cloud_shape_density) as the
// twin's CUDA ops round it: the height's division by the slab's thickness,
// a Python constant, is a multiply by float32(1 / 6000) (atmosphere.cuh).
__device__ __forceinline__ float naive_shape_density(float tex, float r) {
  const bool in_slab = (r > CLOUDS_LOWER_F) && (r < CLOUDS_UPPER_F);
  const float h = (r - CLOUDS_LOWER_F) * (float)(1.0 / 6000.0);
  const bool shape_on = (h - 0.2f < tex * 0.8f) && (0.2f - h < tex * 0.2f);
  const float density = (in_slab && shape_on) ? fmaxf(tex, 0.4f) : 0.0f;
  return density * CLOUDS_DENSITY_F;
}

// The species' total extinction at p: the gases' e . density (e0, e1, e2
// their extinctions, the terms in c), or the cloud's e0 times the
// split-shape density of one tap.
template <int SPECIES>
__device__ __forceinline__ float naive_total(V3 p, float e0, float e1, float e2,
                                             const uint8_t* __restrict__ clouds, int H, int W,
                                             bool bilinear, float c[3]) {
  if constexpr (SPECIES == NAIVE_RMO) {
    float dens[3];
    get_density(sqrtf(dot(p, p)) - PLANET_R_F, dens);
    c[0] = dens[0] * e0;
    c[1] = dens[1] * e1;
    c[2] = dens[2] * e2;
    return (c[0] + c[1]) + c[2];
  } else {
    float s[4];
    sphere_tap<4>(clouds, H, W, p, bilinear, s);
    return e0 * naive_shape_density(s[0], length(p));
  }
}

// (event, t, iid) of one-step Woodcock tracking over [t_start, tm] at the
// global majorant max_ext; an invalid lane keeps (0, t_start, 0). The
// extinctions: the gases' three (SPECIES NAIVE_RMO), or the cloud's in e0.
template <int SPECIES>
__device__ __forceinline__ void naive_delta_lane(Key key, V3 o, V3 d, float t_start, float tm,
                                                 float e0, float e1, float e2, float max_ext,
                                                 bool active, const uint8_t* __restrict__ clouds,
                                                 int H, int W, bool bilinear, int max_steps,
                                                 int& event_out, float& t_out, int& iid_out,
                                                 int* iters = nullptr) {
  const float albedo[4] = {1.0f, 0.95f, 0.0f, 0.99f};  // constants.SCATTERING_ALBEDOS
  const bool valid = active && (tm >= 0.0f) && (t_start < tm);
  const float inv_max = 1.0f / max_ext;
  const float tms = fmaxf(tm, 0.0f);
  float t = t_start;
  int event = 0, iid = 0, it = 0;
  bool done = !valid;
  for (int i = 0; i < max_steps && !done; ++i) {
    ++it;
    const Key ki = fold(key, (uint32_t)i);
    t = t - logf(fmaxf(uniform(ki, 0u), 1e-12f)) * inv_max;
    if (t >= tm) break;  // over: no event
    float c[3];
    const float total = naive_total<SPECIES>(along(o, fminf(t, tms), d), e0, e1, e2, clouds, H,
                                              W, bilinear, c);
    const float u1 = uniform(ki, 1u);
    if (u1 < total * inv_max) {
      int id = 3;
      if constexpr (SPECIES == NAIVE_RMO) {
        const float r = u1 * max_ext;
        const float c01 = c[0] + c[1];
        id = r < c[0] ? 0 : (r < c01 ? 1 : 2);
      }
      event = uniform(ki, 2u) < albedo[id] ? 2 : 1;
      iid = id;
      done = true;
    }
  }
  if (iters) *iters = it;
  event_out = event;
  t_out = t;
  iid_out = iid;
}

// The cloud's transmittance over [t_start, tm] by one-step ratio tracking at
// the global majorant max_ext, ew the cloud's extinction; an invalid lane
// keeps 1.
__device__ __forceinline__ float naive_ratio_lane(Key key, V3 o, V3 d, float t_start, float tm,
                                                  float ew, float max_ext, bool active,
                                                  const uint8_t* __restrict__ clouds, int H,
                                                  int W, bool bilinear, int max_steps,
                                                  int* iters = nullptr) {
  const bool valid = active && (tm >= 0.0f) && (t_start < tm);
  const float inv_max = 1.0f / max_ext;
  const float tms = fmaxf(tm, 0.0f);
  float t = t_start, trans = 1.0f;
  int it = 0;
  bool done = !valid;
  for (int i = 0; i < max_steps && !done; ++i) {
    ++it;
    const float t_new = t - logf(fmaxf(uniform(fold(key, (uint32_t)i), 0u), 1e-12f)) * inv_max;
    if (t_new >= tm) break;  // over: the transmittance stays
    float c[3];
    const float total = naive_total<NAIVE_CLOUD>(along(o, fminf(t_new, tms), d), ew, 0.0f, 0.0f,
                                                  clouds, H, W, bilinear, c);
    trans = trans * (1.0f - total * inv_max);
    done = trans < 1e-5f;
    t = t_new;
  }
  if (iters) *iters = it;
  return trans;
}

}  // namespace de
