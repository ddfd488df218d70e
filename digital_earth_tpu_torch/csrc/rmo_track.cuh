// Woodcock (delta) tracking of a free-flight event through the Rayleigh /
// Mie / ozone gases for one lane, as a device function: the body of the
// rmo_delta_track kernel (rmo_delta_track.cu) and of the bounce kernel's
// flight (bounce.cuh). Below it, ratio tracking of the gases'
// transmittance (rmo_ratio_lane): the body of the rmo_ratio_track kernel
// (rmo_ratio_track.cu) and of the bounce's sun transmittance when
// TraceConfig.analytic_transmittance is False.
//
// Per lane and iteration i it draws the reference's threefry stream
// uniform(fold(key, i), (3, K)) (digital_earth_tpu/render/pathtracer.py:631
// _delta_track_rmo; with FAST, TraceConfig.fast_loop_rng, the counter hash
// fast_uniform(key, i, (3, K)) of fast_rng.cuh), rebuilds the local hero majorant from the density
// envelope at the minimum radius of the remaining segment, takes K
// exponential steps (prefix sums in the reference's sequential order), and
// resolves the first probe that is real or past t_max: species by the hero
// extinction CMF, scatter vs absorb by albedo roulette. Cap max_steps
// iterations.
#pragma once
#include <cstdint>

#include "atmosphere.cuh"
#include "fast_rng.cuh"
#include "threefry.cuh"

namespace de {

// (event, t, iid) of the flight from t_start toward t_max with the hero
// extinction (e0, e1, e2); an invalid lane keeps (0, t_start, 0). With
// ``iters`` the loop's iterations are written there. FAST: the counter
// hash's draws.
template <bool FAST = false>
__device__ __forceinline__ void rmo_track_lane(Key key, V3 o, V3 d, float t_start, float tm,
                                               float e0, float e1, float e2, bool active,
                                               int max_steps, int k, float o3_env_peak,
                                               int& event_out, float& t_out, int& iid_out,
                                               int* iters = nullptr) {
  const float albedo[3] = {1.0f, 0.95f, 0.0f};
  float t = t_start;
  const bool valid = active && (tm >= 0.0f) && (t < tm);
  const float tms = fmaxf(tm, 0.0f);
  const float rp = perigee_radius(o, d);
  const float xp = dot(o, d);
  const float x_end = tms + xp;

  int event = 0, iid = 0;
  bool done = !valid;
  int it = 0;
  for (int i = 0; i < max_steps && !done; ++i) {
    ++it;
    const Key ki = loop_key<FAST>(key, (uint32_t)i);
    const float r_min = segment_min_radius(rp, t + xp, x_end);
    float env[3];
    density_envelope(r_min - PLANET_R_F, o3_env_peak, env);
    const float inv_max = 1.0f / fmaxf(dot3(e0, e1, e2, env[0], env[1], env[2]), 1e-20f);
    float cs = 0.0f, ts = t;
    for (int j = 0; j < k; ++j) {
      const float u0 = loop_uniform<FAST>(ki, (uint32_t)i, (uint32_t)j);
      const float step = -logf(fmaxf(u0, 1e-12f)) * inv_max;
      cs = j == 0 ? step : cs + step;
      ts = t + cs;
      const V3 p = along(o, fminf(ts, tms), d);
      float dens[3];
      get_density(sqrtf(dot(p, p)) - PLANET_R_F, dens);
      const float total = dot3(dens[0], dens[1], dens[2], e0, e1, e2);
      const bool over = ts >= tm;
      const float u1 = loop_uniform<FAST>(ki, (uint32_t)i, (uint32_t)(k + j));
      if (over || u1 < total * inv_max) {
        if (!over) {
          const float r = u1 / inv_max;
          const float c0 = dens[0] * e0;
          const float c01 = c0 + dens[1] * e1;
          const int id = r < c0 ? 0 : (r < c01 ? 1 : 2);
          const float u2 = loop_uniform<FAST>(ki, (uint32_t)i, (uint32_t)(2 * k + j));
          event = u2 < albedo[id] ? 2 : 1;
          iid = id;
        }
        done = true;
        break;
      }
    }
    t = ts;
  }
  if (iters) *iters = it;
  event_out = event;
  t_out = t;
  iid_out = iid;
}

// Residual ratio tracking of the gases' transmittance over [t_start, tm]
// for the L wavelengths of one lane (digital_earth_tpu/render/pathtracer.py
// :814 _ratio_track_rmo), one free-flight stream at the packet majorant
// max_ext. Iteration i draws uniform(fold(key, i), (K,)); probe j steps by
// -log(max(u_j, 1e-12)) / max_ext from the iteration's start (prefix sums in
// the reference's sequential order), and a probe before tm multiplies
// wavelength l's factor by 1 - ext[l] . dens / max_ext, the factors taken
// in order of j, then the transmittance by the iteration's factor. The
// probes after the first one at or past tm change nothing and end the lane,
// so they are not drawn. A lane also ends once every wavelength's
// transmittance is below 1e-5, or after max_steps iterations. An invalid
// lane keeps 1. With ``iters`` the loop's iterations are written there.
// FAST: the draws fast_uniform(key, i, (K,)).
template <int L, bool FAST = false>
__device__ __forceinline__ void rmo_ratio_lane(Key key, V3 o, V3 d, float t_start, float tm,
                                               const float (&ext)[L][3], float max_ext,
                                               bool active, int max_steps, int k, float (&trans)[L],
                                               int* iters = nullptr) {
#pragma unroll
  for (int l = 0; l < L; ++l) trans[l] = 1.0f;
  const bool valid = active && (tm >= 0.0f) && (t_start < tm);
  const float inv_max = 1.0f / max_ext;
  const float tms = fmaxf(tm, 0.0f);
  float t = t_start;
  bool done = !valid;
  int it = 0;
  for (int i = 0; i < max_steps && !done; ++i) {
    ++it;
    const Key ki = loop_key<FAST>(key, (uint32_t)i);
    float block[L];
#pragma unroll
    for (int l = 0; l < L; ++l) block[l] = 1.0f;
    float cs = 0.0f, ts = t;
    for (int j = 0; j < k; ++j) {
      const float step =
          -logf(fmaxf(loop_uniform<FAST>(ki, (uint32_t)i, (uint32_t)j), 1e-12f)) * inv_max;
      cs = j == 0 ? step : cs + step;
      ts = t + cs;
      if (!(ts < tm)) break;  // this probe and the later ones (ts grows) stay 1
      const V3 p = along(o, fminf(ts, tms), d);
      float dens[3];
      get_density(sqrtf(dot(p, p)) - PLANET_R_F, dens);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float total = dot3(dens[0], dens[1], dens[2], ext[l][0], ext[l][1], ext[l][2]);
        block[l] = block[l] * (1.0f - total * inv_max);
      }
    }
    float most = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      trans[l] = trans[l] * block[l];
      most = l == 0 ? trans[l] : fmaxf(most, trans[l]);
    }
    t = ts;
    done = ts >= tm || most < 1e-5f;
  }
  if (iters) *iters = it;
}

}  // namespace de
