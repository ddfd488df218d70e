// The gases' free flight by inverting their optical depth on the density
// table, for one lane, as a device function: the body of the
// flight_analytic kernel (flight_analytic.cu) and of the bounce's RMO
// flight in its options instances at TraceConfig.analytic_flight
// (bounce.cuh).
//
// Replaces the TPU loop digital_earth_tpu/models/atmosphere_lut.py:357 (the
// fori_loop of sample_flight_distance, :302-359) and its caller
// digital_earth_tpu/render/pathtracer.py:749 _sample_rmo_flight_analytic,
// as the port's twins models/atmosphere_lut.sample_flight_distance_plain
// and render/tracers.sample_rmo_flight_analytic_plain compute them. Per
// lane: three draws uniform(key, 0..2); tau(t) = ext_h . max(sign(x) F(rp,
// |x|) - f0, 0), x = t + xp, from the table (density_lut.cuh lut_f_eval);
// the lane collides where -ln u0 < tau(t_end); a colliding lane runs
// n_iter safeguarded Newton steps on tau(t) = -ln u0 (the step t - f /
// sigma, sigma the hero extinction at t; a step leaving the bracket or not
// finite bisects it) and clamps t to its span; then the species by the
// extinction's CMF at t (u1) and the albedo roulette (u2). A lane that does
// not collide keeps the span's end whatever the steps would give, so it
// runs none; the census counts n_iter steps for a lane that does.
//
// What bounds it on the H100: each step is two dependent table rows (24 B
// each, from L2: the table is 384 x 1024 x 3 float32, 4.7 MB), a logf-free
// chain of about 90 FP32 operations and the gases' three densities (two
// expf and the ozone profile). Every colliding lane runs exactly n_iter
// steps, so a warp diverges only between colliding and escaping lanes.
#pragma once
#include <cstdint>

#include "atmosphere.cuh"
#include "density_lut.cuh"
#include "threefry.cuh"

namespace de {

// ext_h . max(sign(x) F(rp, |x|) - f0, 0)
__device__ __forceinline__ float flight_tau(const float* __restrict__ table, float rp, float x,
                                            const float (&f0)[3], float e0, float e1, float e2) {
  float f[3];
  lut_f_eval(table, rp, fabsf(x), f);
  const float s = torch_sign(x);
  return dot3(e0, e1, e2, fmaxf(s * f[0] - f0[0], 0.0f), fmaxf(s * f[1] - f0[1], 0.0f),
              fmaxf(s * f[2] - f0[2], 0.0f));
}

// (event, t, iid) of the gases' flight from t_start toward tm with the hero
// extinction (e0, e1, e2), drawn from key; with ``iters`` the steps taken
// (n_iter for a colliding lane, else 0) are written there.
__device__ __forceinline__ void flight_analytic_lane(const float* __restrict__ table, Key key,
                                                     V3 o, V3 d, float t_start, float tm,
                                                     float e0, float e1, float e2, bool active,
                                                     int n_iter, int& event_out, float& t_out,
                                                     int& iid_out, int* iters = nullptr) {
  const float albedo[3] = {1.0f, 0.95f, 0.0f};
  const float u0 = uniform(key, 0u);
  const bool valid = (tm >= 0.0f) && (t_start < tm);
  const float t_end = valid ? tm : t_start;
  const float rp = perigee_radius(o, d);
  const float xp = dot(o, d);
  const float x0 = t_start + xp;
  float f0[3];
  lut_f_eval(table, rp, fabsf(x0), f0);
  const float s0 = torch_sign(x0);
#pragma unroll
  for (int c = 0; c < 3; ++c) f0[c] = s0 * f0[c];
  const float tau_total = flight_tau(table, rp, t_end + xp, f0, e0, e1, e2);
  const float target = -logf(fmaxf(u0, 1e-12f));
  const bool collided = valid && target < tau_total;
  float t = t_end;
  if (collided) {
    float lo = t_start, hi = t_end;
    t = 0.5f * (t_start + t_end);
    for (int it = 0; it < n_iter; ++it) {
      const float f = flight_tau(table, rp, t + xp, f0, e0, e1, e2) - target;
      const float x = t + xp;
      float dens[3];
      get_density(fmaxf(sqrtf(rp * rp + x * x) - PLANET_R_F, 0.0f), dens);
      const float sigma = dot3(e0, e1, e2, dens[0], dens[1], dens[2]);
      if (f <= 0.0f) lo = t;
      if (f > 0.0f) hi = t;
      const float t_n = t - f / fmaxf(sigma, 1e-30f);
      t = (t_n > lo && t_n < hi && isfinite(t_n)) ? t_n : 0.5f * (lo + hi);
    }
    t = fminf(fmaxf(t, t_start), t_end);
  }
  if (iters) *iters = collided ? n_iter : 0;
  int event = 0, iid = 0;
  if (collided && active) {
    const V3 p = along(o, t, d);
    float dens[3];
    get_density(sqrtf(dot(p, p)) - PLANET_R_F, dens);
    const float c0 = dens[0] * e0;
    const float c01 = c0 + dens[1] * e1;
    const float r = uniform(key, 1u) * fmaxf(c01 + dens[2] * e2, 1e-30f);
    iid = r < c0 ? 0 : (r < c01 ? 1 : 2);
    event = uniform(key, 2u) < albedo[iid] ? 2 : 1;
  }
  event_out = event;
  t_out = t;
  iid_out = iid;
}

}  // namespace de
