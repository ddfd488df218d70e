// Per-lane volume physics of the bounce as device functions, each rounding
// as the port's twin in models/volume.py does on the card: spectral
// extinctions (Rayleigh, Mie, ozone), phase functions and their samplers for
// every interaction id, including the exact Draine inverse CDF
// (digital_earth_tpu/models/volume.py:111-190).
//
// Python constants enter as the float32 of the double the twin computes
// (PY(x) below, the double arithmetic done at compile time in the twin's
// order; values that need exp or pow are given as exact hex doubles). A
// division by a Python constant b is a multiply by float32(1 / b), the
// reciprocal taken in double and then rounded, as PyTorch's CUDA ops apply a
// CPU scalar divisor (chip_smoke.py measures it; 1.0f / float32(b) differs
// for some b, a - a g^2 of the Draine lobe among them); a division by a
// tensor, or rdiv(a, x), is a true division. torch.pow(x, 2.0) is x * x on the card;
// any other constant exponent is powf (PyTorch's pow kernel).
#pragma once

#include "atmosphere.cuh"

namespace de {

#define PY(x) ((float)(x))

constexpr double PI_D = 3.141592653589793;  // math.pi
constexpr double AIR_NUM_DENSITY_D = 2.5035422e25;
constexpr double OZONE_NUM_DENSITY_D = AIR_NUM_DENSITY_D * 0.012588 * 8e-6;
constexpr double MIE_ASYMMETRY_D = 3000.0;
// models/volume.py cloud droplet constants (exp of the droplet-size fits)
constexpr double CLOUD_G_HG_FULL_D = 0x1.f80c5bd105b86p-1;
constexpr double CLOUD_G_HG_REDUCED_D = 0.91;
constexpr double CLOUD_G_DRAINE_D = 0x1.15064c0ddba00p-1;
constexpr double CLOUD_ALPHA_DRAINE_D = 0x1.453601914006ep+4;
constexpr double CLOUD_W_DRAINE_D = 0x1.e5027b3d4e7fbp-2;
constexpr double CBRT2_D = 0x1.428a2f98d728bp+0;            // 2.0 ** (1.0 / 3.0)
constexpr double EIGHT_PI3_D = 0x1.f019b59389d7bp+7;        // 8.0 * math.pi ** 3

__device__ __forceinline__ V3 normalize3(V3 v) {
  const float l = fmaxf(length(v), 1e-20f);
  return V3{v.x / l, v.y / l, v.z / l};
}

// ops/math_utils.make_orthonormal_basis
__device__ __forceinline__ void orthonormal_basis(V3 n, V3& x, V3& y) {
  const V3 h = fabsf(n.y) > PY(0.9) ? V3{1.0f, 0.0f, 0.0f} : V3{0.0f, 1.0f, 0.0f};
  y = normalize3(cross(n, h));
  x = cross(n, y);
}

// ops/math_utils.spherical_direction in the (x, y, z) frame
__device__ __forceinline__ V3 spherical_direction(float sin_t, float cos_t, float phi, V3 x,
                                                  V3 y, V3 z) {
  const float a = sin_t * cosf(phi), b = sin_t * sinf(phi);
  return V3{(a * x.x + b * y.x) + cos_t * z.x, (a * x.y + b * y.y) + cos_t * z.y,
            (a * x.z + b * y.z) + cos_t * z.z};
}

// --- spectral extinctions (wavelength in nm) ------------------------------

__device__ __forceinline__ float spectra_extinction_rayleigh(float wl) {
  const float wavelength_m = wl * PY(1e-9);
  const float wl2 = wl * wl;
  const float f_n2 = PY(1.034) + PY(3.17e-4) / wl2;
  const float f_o2 = (PY(1.096) + PY(1.385e-3) / wl2) + PY(1.448e-4) / (wl2 * wl2);
  const float king = (((PY(78.084) * f_n2 + PY(20.946) * f_o2) + PY(0.934)) + PY(0.0421 * 1.15)) *
                     PY(1.0 / (78.084 + 20.946 + 0.934 + 0.0421));
  // air_ior(wavelength_um)
  const float wum = wl * PY(1e-3);
  const float rcp = 1.0f / (wum * wum);
  const float ior = (PY(1.0 + 8.06051e-5) + PY(2.480990e-2) / (PY(132.274) - rcp)) +
                    PY(1.74557e-4) / (PY(39.32957) - rcp);
  const float n = ior * ior - 1.0f;
  return ((PY(EIGHT_PI3_D) * (n * n)) /
          (PY(3.0 * AIR_NUM_DENSITY_D) * powf(wavelength_m, 4.0f))) * king;
}

__device__ __forceinline__ float spectra_extinction_mie(float wl) {
  constexpr double c = (0.6544 * 1.06 - 0.6510) * 4e-18;
  const float k = (PY(0.773335) - PY(0.00386891) * wl) / (1.0f - PY(0.00546759) * wl);
  const float q = PY(2.0 * PI_D) / (wl * PY(1e-9));
  return (PY(0.434 * c * PI_D) * (q * q)) * k;
}

// o3 is the (441,) cross-section table of 390-830 nm.
__device__ __forceinline__ float spectra_extinction_ozone(float wl, const float* __restrict__ o3) {
  const int idx = min(max((int)(wl - 390.0f), 0), 440);
  const bool in_range = (wl >= 390.0f) && (wl < 831.0f);
  return in_range ? PY(1e-4 * OZONE_NUM_DENSITY_D) * o3[idx] : 0.0f;
}

// --- phase functions ------------------------------------------------------

__device__ __forceinline__ float rayleigh_phase(float c) {
  return PY(3.0 / (16.0 * PI_D)) * (1.0f + c * c);
}

__device__ __forceinline__ float mie_phase(float c) {  // Klein-Nishina, e = 3000
  const float log_term = logf(PY(2.0 * MIE_ASYMMETRY_D + 1.0));
  return PY(MIE_ASYMMETRY_D) /
         ((PY(2.0 * PI_D) * (PY(MIE_ASYMMETRY_D) * (1.0f - c) + 1.0f)) * log_term);
}

// HG + Draine mixture; reduce_peak selects the multi-scatter 0.91 HG peak.
__device__ __forceinline__ float cloud_phase(float c, bool reduce_peak) {
  constexpr double g = CLOUD_G_DRAINE_D, a = CLOUD_ALPHA_DRAINE_D;
  const float gh = reduce_peak ? PY(CLOUD_G_HG_REDUCED_D) : PY(CLOUD_G_HG_FULL_D);
  const float gh2 = gh * gh;
  const float hg = (1.0f - gh2) / (PY(4.0 * PI_D) * powf((1.0f + gh2) - (2.0f * gh) * c, 1.5f));
  const float draine =
      (PY(1.0 - g * g) * (1.0f + (PY(a) * c) * c)) /
      (PY(4.0 * (1.0 + (a * (1.0 + 2.0 * g * g)) / 3.0) * PI_D) *
       powf(PY(1.0 + g * g) - PY(2.0 * g) * c, 1.5f));
  return hg * PY(1.0 - CLOUD_W_DRAINE_D) + draine * PY(CLOUD_W_DRAINE_D);
}

// Phase value toward the light for interaction id iid (0 Rayleigh, 1 Mie,
// 3 cloud, 4 isotropic cloud; ozone absorbs only).
__device__ __forceinline__ float evaluate_phase(V3 ray_dir, V3 light_dir, int iid,
                                                bool reduce_peak) {
  const float c = dot(ray_dir, light_dir);
  if (iid == 0) return rayleigh_phase(c);
  if (iid == 1) return mie_phase(c);
  if (iid == 3) return cloud_phase(c, reduce_peak);
  if (iid == 4) return PY(1.0 / (4.0 * PI_D));
  return 0.0f;
}

// --- phase samplers -------------------------------------------------------

__device__ __forceinline__ V3 direction_about(V3 view, float cos_t, float u_phi) {
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const float phi = PY(2.0 * PI_D) * u_phi;
  V3 tang, bitang;
  orthonormal_basis(view, tang, bitang);
  return spherical_direction(sin_t, cos_t, phi, tang, bitang, view);
}

__device__ __forceinline__ float sample_hg_cos(float u, float g) {
  const float sqr_term = (1.0f - g * g) / ((1.0f - g) + (2.0f * g) * u);
  return ((1.0f + g * g) - sqr_term * sqr_term) / (2.0f * g);
}

__device__ __forceinline__ float sample_klein_nishina_cos(float u) {
  return ((-powf(PY(2.0 * MIE_ASYMMETRY_D + 1.0), 1.0f - u) + PY(MIE_ASYMMETRY_D)) + 1.0f) *
         PY(1.0 / MIE_ASYMMETRY_D);
}

// Exact Draine inverse-CDF cos(theta) (Jendersie & d'Eon 2023) for the cloud
// droplet's (g, alpha); the g- and alpha-only terms are the twin's Python
// doubles. With ``trace`` the intermediates t3, t4a, t4, t4p3, t6, t5, inner,
// s and the unclamped cos are written there (draine_check.cu).
__device__ __forceinline__ float sample_draine_cos(float u, float* trace = nullptr) {
  constexpr double g = CLOUD_G_DRAINE_D, a = CLOUD_ALPHA_DRAINE_D;
  constexpr double g2 = g * g, g3 = g * g2, g4 = g2 * g2, g6 = g2 * g4;
  constexpr double pgp1_2 = (1.0 + g2) * (1.0 + g2);
  constexpr double t1a = -a + a * g4;
  constexpr double t1a3 = t1a * t1a * t1a;
  constexpr double t2 = -1296.0 * (-1.0 + g2) * (a - a * g2) * t1a * (4.0 * g2 + a * pgp1_2);
  constexpr double t4b = -144.0 * a * g2 + 288.0 * a * g4 - 144.0 * a * g6;
  constexpr double t4b3 = t4b * t4b * t4b;
  const float m = -1.0f + 2.0f * u;
  const float t3 = PY(3.0 * g2) * (1.0f + PY(g) * m) +
                   PY(a) * (PY(2.0 + g2) + PY(g3 * (1.0 + 2.0 * g2)) * m);
  const float t4a = PY(432.0 * t1a3 + t2) + (PY(432.0 * (a - a * g2)) * t3) * t3;
  const float t4 = t4a + sqrtf(fmaxf(PY(-4.0 * t4b3) + t4a * t4a, 0.0f));
  const float t4p3 = powf(t4, PY(1.0 / 3.0));
  const float t6 = ((PY(2.0 * t1a) + PY(48.0 * CBRT2_D * (-(a * g2) + 2.0 * a * g4 - a * g6)) / t4p3) +
                    t4p3 * PY(1.0 / (3.0 * CBRT2_D))) *
                   PY(1.0 / (a - a * g2));
  const float t5 = PY(6.0 * (1.0 + g2)) + t6;
  const float inner =
      (PY(6.0 * (1.0 + g2)) - (8.0f * t3) / (PY(a * (-1.0 + g2)) * sqrtf(fmaxf(t5, 1e-20f)))) - t6;
  const float s = -0.5f * sqrtf(fmaxf(t5, 0.0f)) + sqrtf(fmaxf(inner, 0.0f)) * 0.5f;
  const float cos_t = (PY(1.0 + g2) - s * s) * PY(1.0 / (2.0 * g));
  if (trace) {
    const float t[9] = {t3, t4a, t4, t4p3, t6, t5, inner, s, cos_t};
    for (int j = 0; j < 9; ++j) trace[j] = t[j];
  }
  return fminf(fmaxf(cos_t, -1.0f), 1.0f);
}

__device__ __forceinline__ V3 sample_sphere(float u0, float u1) {
  const float ang = (u0 * 2.0f) * PY(PI_D);
  const float y = u1 * 2.0f - 1.0f;
  const float ground = sqrtf(fmaxf(1.0f - y * y, 0.0f));
  return normalize3(V3{sinf(ang) * ground, cosf(ang) * ground, y});
}

// The phase sample of interaction id iid about ``view``: direction and
// phase / pdf (ops/volume.sample_phase_dirs, the branch of the lane's id).
__device__ __forceinline__ void sample_phase_dir(float u_mix, float u0, float u1, V3 view,
                                                 int iid, bool reduce_peak, V3& dir,
                                                 float& phase_div_pdf) {
  const bool is_iso = iid == 4;
  if (iid == 0 || is_iso) {
    dir = sample_sphere(u0, u1);
    const float uni = is_iso ? PY(1.0 / (4.0 * PI_D)) : rayleigh_phase(dot(view, dir));
    phase_div_pdf = uni * PY(4.0 * PI_D);
    return;
  }
  phase_div_pdf = 1.0f;
  if (iid == 1) {
    dir = direction_about(view, sample_klein_nishina_cos(u0), u1);
    return;
  }
  const float gh = reduce_peak ? PY(CLOUD_G_HG_REDUCED_D) : PY(CLOUD_G_HG_FULL_D);
  const float cos_t = u_mix < PY(CLOUD_W_DRAINE_D) ? sample_draine_cos(u0) : sample_hg_cos(u0, gh);
  dir = direction_about(view, cos_t, u1);
}

}  // namespace de
