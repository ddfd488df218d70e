// The preview's single-scatter march for one lane, as a device function: the
// body of the atmos_march kernel (atmos_march.cu) and of the preview kernel's
// marches (preview.cu).
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

__device__ __forceinline__ float sun_transmittance(V3 pos, V3 sd, const float ext[3]) {
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

// The 64-step march of the ray o + t d over [ts, tm] toward the sun
// direction sd: (in_scatter, transmittance) of an active lane. ext holds
// the lane's RMO extinctions, sc0 and sc1 its Rayleigh and Mie scattering.
__device__ __forceinline__ void atmos_march_lane(V3 o, V3 d, float ts, float tm, V3 sd,
                                                 const float ext[3], float sc0, float sc1,
                                                 PhaseConsts pc, float& in_scatter_out,
                                                 float& trans_out) {
  const float dd = (tm - ts) / (float)ATMOS_MARCH_STEPS;
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
  in_scatter_out = in_scatter;
  trans_out = trans;
}

}  // namespace de
