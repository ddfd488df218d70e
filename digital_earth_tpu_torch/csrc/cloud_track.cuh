// Space-skipping tracking of the cloud slab for one lane, as a device
// function: the body of the cloud_track kernel (cloud_track.cu) and of the
// bounce kernel's cloud flight and sun transmittance (bounce.cu). Delta mode
// gives the first real collision (event and distance), ratio mode the
// transmittance with Russian roulette.
//
// Per lane and iteration i, with the threefry draws uniform(fold(key, i),
// (3, K)) of the TPU loop digital_earth_tpu/render/pathtracer.py:906
// _track_cloud:
//   - skip mode (no local majorant): K probes at the lane's stride, each
//     tap certifying emptiness through the tight / wide / coarse max-mip
//     channel its stride level needs (6 / 20 / 100 km strides);
//   - tracking mode: K Woodcock steps against the local tight-mip majorant,
//     clamped to its 8 km validity, with the split-shape density
//     (pathtracer.py:590 _cloud_shape_density);
//   - then the analytic radial-band skip (pathtracer.py:603
//     _cloud_band_radii) from the stopping tap.
// Probes after the first stopping one do not change the result; the sweep
// stops there (ratio mode: at the first budget crossing). Only a tracking
// iteration folds the iteration key: a skipping one draws nothing.
//
// OPTS: the options instance, whose taps are bilinear where ``bilinear``
// (TraceConfig.bilinear_tracking; the twin's sample_sphere_texture as it
// rounds on the card, texture.cuh sphere_tap); OPTS false compiles in the
// nearest taps of the default. FAST: the draws are the counter hash
// fast_uniform(key, i, (3, K)) (TraceConfig.fast_loop_rng; fast_rng.cuh).
#pragma once
#include <cstdint>

#include "atmosphere.cuh"
#include "fast_rng.cuh"
#include "texture.cuh"
#include "threefry.cuh"

namespace de {

__device__ __forceinline__ float shape_density(float tex, float r) {
  const bool in_slab = (r > CLOUDS_LOWER_F) && (r < CLOUDS_UPPER_F);
  const float h = (r - CLOUDS_LOWER_F) / CLOUDS_THICKNESS_F;
  const bool shape_on = (h - 0.2f < tex * 0.8f) && (0.2f - h < tex * 0.2f);
  const float density = (in_slab && shape_on) ? fmaxf(tex, 0.4f) : 0.0f;
  return density * CLOUDS_DENSITY_F;
}

// (event, t) in delta mode, the transmittance in ratio mode; an invalid lane
// keeps (0, t_start, 1). With ``iters`` the loop's iterations are written
// there.
template <bool OPTS = false, bool FAST = false>
__device__ __forceinline__ void cloud_track_lane(Key key, V3 o, V3 d, float t_start, float tm,
                                                 float ew, bool active,
                                                 const uint8_t* __restrict__ clouds, int H,
                                                 int W, int max_steps, int k, bool ratio,
                                                 int& event_out, float& t_out,
                                                 float& trans_out, int* iters = nullptr,
                                                 bool bilinear = false) {
  float t = t_start;
  const bool valid = active && (tm >= 0.0f) && (t < tm);
  const float tms = fmaxf(tm, 0.0f);
  // mip channels of a tap: s[1] tight (8 km), s[2] coarse (115 km), s[3] wide (25 km)
  const float band_valid[3] = {8e3f, 25e3f, 115e3f};  // tight, wide, coarse

  bool done = !valid;
  float t_fetch = t, sig = 0.0f, stride = 6e3f, trans = 1.0f;
  int event = 0, it = 0;
  for (int i = 0; i < max_steps && !done; ++i) {
    ++it;
    const bool skipping = sig <= 0.0f;
    const Key ki = skipping ? Key{0u, 0u} : loop_key<FAST>(key, (uint32_t)i);
    const float budget_end = fminf(t_fetch + 8e3f, tm);
    float t_new = t, mf = 0.0f, mc = 0.0f, mw = 0.0f;
    bool stopped = false, wood_real = false;
    float u2_stop = 0.0f, block = 1.0f;

    if (skipping) {
      const bool lvl_coarse = stride > 30000.0f;
      const bool lvl_wide = !lvl_coarse && (stride > 9000.0f);
      for (int j = 0; j < k; ++j) {
        const float ts = t + (float)j * stride;
        const bool crossed = ts >= tm;
        const float tsc = fminf(ts, tms);
        float s[4];
        if (OPTS && bilinear) sphere_tap<4>(clouds, H, W, along(o, tsc, d), true, s);
        else sphere_tap_nearest<4>(clouds, H, W, along(o, tsc, d), s);
        mf = s[1];
        mc = s[2];
        mw = s[3];
        const bool occ = lvl_coarse ? (mc > 0.0f) : (lvl_wide ? (mw > 0.0f) : (mf > 0.0f));
        if (occ || crossed) {
          t_new = tsc;
          stopped = true;
          break;
        }
      }
      if (!stopped) t_new = t + (float)k * stride;
    } else {
      const float sigc = fmaxf(sig, 1e-20f);
      const float clamp_end = fminf(budget_end, tms);
      float cs = 0.0f;
      for (int j = 0; j < k; ++j) {
        const float u0 = loop_uniform<FAST>(ki, (uint32_t)i, (uint32_t)j);
        const float step = -logf(fmaxf(u0, 1e-12f)) / sigc;
        cs = j == 0 ? step : cs + step;
        const float ts = t + cs;
        const bool crossed = ts >= budget_end;
        const float tsc = fminf(ts, clamp_end);
        const V3 p = along(o, tsc, d);
        float s[4];
        if (OPTS && bilinear) sphere_tap<4>(clouds, H, W, p, true, s);
        else sphere_tap_nearest<4>(clouds, H, W, p, s);
        t_new = tsc;
        mf = s[1];
        mc = s[2];
        mw = s[3];
        if (crossed) break;  // the budget crossing ends the sweep in both modes
        const float ratio_j = ew * shape_density(s[0], length(p)) / sigc;
        if (ratio) {
          block = block * (1.0f - ratio_j);
        } else if (loop_uniform<FAST>(ki, (uint32_t)i, (uint32_t)(k + j)) < ratio_j) {
          wood_real = true;
          u2_stop = loop_uniform<FAST>(ki, (uint32_t)i, (uint32_t)(2 * k + j));
          break;
        }
      }
    }

    float sig_new = mf > 0.0f ? ew * CLOUDS_DENSITY_F * fmaxf(mf, 0.4f) : 0.0f;
    const float stride_new = mc <= 0.0f ? 100e3f : (mw <= 0.0f ? 20e3f : 6e3f);
    float t_fetch_new = t_new;

    if (!ratio) {
      if (!skipping && wood_real) {
        event = u2_stop < 0.99f ? 2 : 1;
        done = true;
      }
    } else {
      if (!skipping) {
        trans = trans * block;
        const float p_cont = fminf(fmaxf(trans / 0.05f, 0.0f), 1.0f);
        if (p_cont < 1.0f) {
          if (loop_uniform<FAST>(ki, (uint32_t)i, (uint32_t)(2 * k)) >= p_cont) {
            trans = 0.0f;
            done = true;
          } else {
            trans = trans / p_cont;
          }
        }
      }
      done = done || (trans < 1e-5f);
    }

    // analytic radial-band skip from the stop tap
    const bool at_tap = !skipping || stopped;
    float jump = 0.0f;
    if (!done && at_tap) {
      const V3 ps = along(o, t_new, d);
      const float b_stop = dot(ps, d);
      const V3 crs = cross(ps, d);
      const float h2s = dot(crs, crs);
      const float r_stop = length(ps);
      const float mips3[3] = {mf, mw, mc};
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float lo = CLOUDS_LOWER_F + 1200.0f * (1.0f - mips3[m]);
        const float hi = CLOUDS_LOWER_F + CLOUDS_THICKNESS_F * (0.2f + mips3[m] * 0.8f);
        const bool above = r_stop > hi + 4.0f;
        const bool below = r_stop < lo - 4.0f;
        const float dh = hi * hi - h2s;
        const float hi_near = dh < 0.0f ? -1.0f : -b_stop - sqrtf(fmaxf(dh, 0.0f));
        const float dl = lo * lo - h2s;
        const float lo_far = dl < 0.0f ? -1.0f : -b_stop + sqrtf(fmaxf(dl, 0.0f));
        const float t_ent = above ? (hi_near > 0.0f ? hi_near : 3e7f)
                                  : (below ? fmaxf(lo_far, 0.0f) : 0.0f);
        const float jm = fminf(t_ent, band_valid[m]);
        jump = m == 0 ? jm : fmaxf(jump, jm);
      }
    }
    t_new = t_new + jump;
    if (jump > 0.0f) {
      sig_new = 0.0f;
      t_fetch_new = t_new;
    }
    done = done || (t_new >= tm);
    t = t_new;
    t_fetch = t_fetch_new;
    sig = sig_new;
    stride = stride_new;
  }
  if (iters) *iters = it;
  event_out = event;
  t_out = t;
  trans_out = trans;
}

}  // namespace de
