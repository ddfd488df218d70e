// The density-integral table lookups as device functions: per-species line
// integrals of the Rayleigh / Mie / ozone densities from the (384, 1024, 3)
// float32 table F(rp_i, x_j) (models/atmosphere_lut.py, built once per
// device), and the exact RMO transmittance to space.
//
// Replaces the reference's digital_earth_tpu/models/atmosphere_lut.py:207-299
// (_f_eval, _f_tot, density_integral_segment, density_integral_to_space) and
// :385 rmo_transmittance_to_space. Each step rounds as the port's twins in
// models/atmosphere_lut.py do on the card: op by op, a division by a Python
// constant as a multiply by its float32 reciprocal (PyTorch's CUDA ops apply
// a CPU scalar divisor so), the radius-aligned bilinear weights in the twin's
// order, the one fused multiply-add of the perigee radius kept.
#pragma once

#include "atmosphere.cuh"

namespace de {

constexpr int LUT_N_RP = 384;
constexpr int LUT_N_X = 1024;
constexpr float LUT_N_DEEP_F = 120.0f;
constexpr double LUT_R_LO_D = 6371e3 - 8e3;
constexpr double LUT_R_TOP_D = 6371e3 + 110e3;
constexpr float LUT_R_LO = (float)LUT_R_LO_D;
constexpr float LUT_R_TOP = (float)LUT_R_TOP_D;
constexpr float LUT_D_MIN = 500.0f;
// float32 of the Python expressions the twins use
constexpr float LUT_DEEP_EDGE = (float)(LUT_R_LO_D - 0.5e3);     // R_LO - _D_MIN
constexpr float LUT_INV_SPAN = 1.0f / (float)(LUT_R_TOP_D - LUT_R_LO_D);
constexpr float LUT_SPAN = (float)(LUT_R_TOP_D - LUT_R_LO_D);
constexpr float LUT_SHELL_ROWS = 263.0f;                         // N_RP - 1 - _N_DEEP
constexpr float LUT_INV_SHELL_ROWS = 1.0f / 263.0f;
constexpr float LUT_INV_N_DEEP = 1.0f / 120.0f;
constexpr float LUT_INV_D_MIN = 1.0f / 500.0f;
constexpr double LUT_LOG_RATIO_D = 0x1.2e71e37ef0cc5p+3;         // log(R_LO / _D_MIN)
constexpr float LUT_LOG_RATIO = (float)LUT_LOG_RATIO_D;
// x / _LOG_RATIO with the Python float divisor is x * float32(1 / _LOG_RATIO)
// on the card (volume.cuh states the rule); 1.0f / LUT_LOG_RATIO differs
constexpr float LUT_INV_LOG_RATIO = (float)(1.0 / LUT_LOG_RATIO_D);
constexpr float LUT_R_LO2 = (float)(LUT_R_LO_D * LUT_R_LO_D);
constexpr float LUT_R_TOP2 = (float)(LUT_R_TOP_D * LUT_R_TOP_D);

__device__ __forceinline__ float lut_lerp(float v0, float v1, float w) {
  return v0 * (1.0f - w) + v1 * w;
}

// Perigee radius -> continuous row index (_rp_to_index).
__device__ __forceinline__ float lut_rp_to_index(float rp) {
  const float shell_idx = LUT_N_DEEP_F + ((rp - LUT_R_LO) * LUT_INV_SPAN) * LUT_SHELL_ROWS;
  const float depth = fminf(fmaxf(LUT_R_LO - rp, LUT_D_MIN), LUT_R_LO);
  const float deep_idx =
      LUT_N_DEEP_F * (1.0f - logf(depth * LUT_INV_D_MIN) * LUT_INV_LOG_RATIO);
  const float i_f = rp < LUT_DEEP_EDGE ? deep_idx : fmaxf(shell_idx, LUT_N_DEEP_F);
  return fminf(fmaxf(i_f, 0.0f), (float)(LUT_N_RP - 1));
}

// Row index -> perigee radius (_index_to_rp).
__device__ __forceinline__ float lut_index_to_rp(int i) {
  const float fi = (float)i;
  const float shell = LUT_R_LO + ((fi - LUT_N_DEEP_F) * LUT_INV_SHELL_ROWS) * LUT_SPAN;
  const float t = (LUT_N_DEEP_F - fi) * LUT_INV_N_DEEP;
  const float deep = LUT_R_LO - LUT_D_MIN * expf(t * LUT_LOG_RATIO);
  return fi < LUT_N_DEEP_F ? deep : shell;
}

__device__ __forceinline__ void lut_row_index(float rp, int& i0, float& wi) {
  const float i_f = lut_rp_to_index(rp);
  i0 = min(max((int)floorf(i_f), 0), LUT_N_RP - 2);
  wi = i_f - (float)i0;
}

// Row i of the table at |x|, at the radius of (rp, x): out[3].
__device__ __forceinline__ void lut_row_val(const float* __restrict__ table, int i, float rp,
                                            float x_abs, float out[3]) {
  const float rp_i = lut_index_to_rp(i);
  const float xi = sqrtf(fmaxf(x_abs * x_abs + (rp - rp_i) * (rp + rp_i), 0.0f));
  const float x_lo = sqrtf(fmaxf(LUT_R_LO2 - rp_i * rp_i, 0.0f));
  const float x_hi = sqrtf(fmaxf(LUT_R_TOP2 - rp_i * rp_i, 0.0f));
  const float u =
      fminf(fmaxf((xi - x_lo) / fmaxf(x_hi - x_lo, 1.0f), 0.0f), 1.0f) * (float)(LUT_N_X - 1);
  const int j0 = min(max((int)floorf(u), 0), LUT_N_X - 2);
  const float wj = u - (float)j0;
  const float* r0 = table + ((size_t)i * LUT_N_X + j0) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = lut_lerp(r0[c], r0[3 + c], wj);
}

// Bilinear F(rp, |x|) (_f_eval), interpolated across perigee rows at equal
// radius.
__device__ __forceinline__ void lut_f_eval(const float* __restrict__ table, float rp,
                                           float x_abs, float out[3]) {
  int i0;
  float wi;
  lut_row_index(rp, i0, wi);
  float a[3], b[3];
  lut_row_val(table, i0, rp, x_abs, a);
  lut_row_val(table, i0 + 1, rp, x_abs, b);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = lut_lerp(a[c], b[c], wi);
}

// F(rp, x_hi) (_f_tot): the full-row integral, linear in rp.
__device__ __forceinline__ void lut_f_tot(const float* __restrict__ table, float rp,
                                          float out[3]) {
  int i0;
  float wi;
  lut_row_index(rp, i0, wi);
  const float* a = table + ((size_t)i0 * LUT_N_X + (LUT_N_X - 1)) * 3;
  const float* b = table + ((size_t)(i0 + 1) * LUT_N_X + (LUT_N_X - 1)) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = lut_lerp(a[c], b[c], wi);
}

__device__ __forceinline__ float torch_sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// Per-species density integrals over the ray parameter [t0, t1].
__device__ __forceinline__ void density_integral_segment(const float* __restrict__ table, V3 o,
                                                         V3 d, float t0, float t1,
                                                         float out[3]) {
  const float rp = perigee_radius(o, d);
  const float xp = dot(o, d);
  const float x0 = t0 + xp, x1 = t1 + xp;
  float f0[3], f1[3];
  lut_f_eval(table, rp, fabsf(x0), f0);
  lut_f_eval(table, rp, fabsf(x1), f1);
  const float s0 = torch_sign(x0), s1 = torch_sign(x1);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = fmaxf(s1 * f1[c] - s0 * f0[c], 0.0f);
}

// Per-species density integrals from o to the top of the atmosphere.
__device__ __forceinline__ void density_integral_to_space(const float* __restrict__ table,
                                                          V3 o, V3 d, float out[3]) {
  const float rp = perigee_radius(o, d);
  const float x0 = dot(o, d);
  float f_end[3], f0[3];
  lut_f_tot(table, rp, f_end);
  lut_f_eval(table, rp, fabsf(x0), f0);
  const float s0 = torch_sign(x0);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = fmaxf(f_end[c] - s0 * f0[c], 0.0f);
}

// exp(-sum_c ext_c D_c) to space for L wavelengths; ext is (L, 3).
template <int L>
__device__ __forceinline__ void rmo_transmittance_to_space(const float* __restrict__ table,
                                                           const float ext[L][3], V3 o, V3 d,
                                                           float out[L]) {
  float dd[3];
  density_integral_to_space(table, o, d, dd);
#pragma unroll
  for (int l = 0; l < L; ++l) out[l] = expf(-dot3(ext[l][0], ext[l][1], ext[l][2], dd[0], dd[1], dd[2]));
}

}  // namespace de
