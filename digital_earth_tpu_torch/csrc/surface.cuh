// Per-lane surface work of the bounce as device functions, each rounding as
// the port's twin does on the card (see volume.cuh for the rules): the
// bump-mapped land SDF and its finite-difference normal, the albedo grading
// of the packed material tap (render/pathtracer.py land_sdf, land_normal,
// get_land_material), the albedo-independent Earth BRDF parts
// (models/surface.py:98 earth_brdf_parts) and the cone and cosine-weighted
// hemisphere samplers (ops/sampling.py:23-45).
#pragma once
#include <cstdint>

#include "atmosphere.cuh"
#include "texture.cuh"
#include "volume.cuh"

namespace de {

__device__ __forceinline__ float sat01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// ops/math_utils.smoothstep with Python edges: (x - e0) / (e1 - e0) is a
// multiply by the float32 reciprocal of the double e1 - e0.
__device__ __forceinline__ float smoothstep_py(double e0, double e1, float x) {
  const float t = sat01((x - (float)e0) * (1.0f / (float)(e1 - e0)));
  return (t * t) * (3.0f - 2.0f * t);
}

// --- land geometry and material ------------------------------------------

struct TexView {
  const uint8_t* data;
  int H, W;
};

// Bump-mapped sphere SDF; channel 0 of the (H, W, 4) topography is height.
__device__ __forceinline__ float land_sdf(TexView topo, V3 p, float scale, bool bilinear) {
  float s[4];
  sphere_tap<4>(topo.data, topo.H, topo.W, p, bilinear, s);
  return (length(p) - PLANET_R_F) - scale * s[0];
}

// Finite-difference normal, 3 extra SDF taps (epsilon = float32(pi R / W)).
__device__ __forceinline__ V3 land_normal(TexView topo, V3 p, float scale, bool bilinear) {
  const float d = land_sdf(topo, p, scale, bilinear);
  const float e = (float)(PI_D * 6371e3 / (double)topo.W);
  const V3 n{d - land_sdf(topo, V3{p.x - e, p.y, p.z}, scale, bilinear),
             d - land_sdf(topo, V3{p.x, p.y - e, p.z}, scale, bilinear),
             d - land_sdf(topo, V3{p.x, p.y, p.z - e}, scale, bilinear)};
  return normalize3(n);
}

struct LandMaterial {
  float albedo[3];  // graded sRGB albedo
  float ocean, bathymetry, emissive;
};

__device__ __forceinline__ float lum(const float x[3]) {
  return x[0] * PY(0.2126729) + x[1] * PY(0.7151522) + x[2] * PY(0.0721750);
}

// Albedo grading from one packed 8-channel material tap.
__device__ __forceinline__ LandMaterial get_land_material(TexView material, V3 p,
                                                          bool bilinear) {
  float mat[8];
  sphere_tap<8>(material.data, material.H, material.W, p, bilinear, mat);
  const float a[3] = {mat[0], mat[1], mat[2]};
  const float ocean = mat[3];
  const float la0 = lum(a);
  float la[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) la[c] = la0 + (a[c] - la0) * 6.5f;
  const float q = la[1] / fmaxf(lum(la), 1e-8f);
  const float green = smoothstep_py(1.5, 1.9, q * q);
  const float gden = green * PY(0.7) + 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) la[c] = a[c] / gden;
  const float l2 = lum(la);
  const float t2 = PY(1.4) - green * PY(0.45);
#pragma unroll
  for (int c = 0; c < 3; ++c) la[c] = l2 + (la[c] - l2) * t2;
  const float warm[3] = {255.0f * (1.0f / 255.0f), 128.0f * (1.0f / 255.0f),
                         64.0f * (1.0f / 255.0f)};
  const float t3 = PY(0.2) * (1.0f - green);
#pragma unroll
  for (int c = 0; c < 3; ++c) la[c] = la[c] + (la[c] * warm[c] - la[c]) * t3;
  LandMaterial m;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float oa = (la0 + (a[c] - la0) * 0.75f) * PY(0.9);
    m.albedo[c] = la[c] + (oa - la[c]) * ocean;
  }
  m.ocean = ocean;
  m.bathymetry = mat[4];
  m.emissive = mat[5];
  return m;
}

// --- BRDF -----------------------------------------------------------------

__device__ __forceinline__ float fresnel_dielectric(float v_dot_h, float f0) {
  float eta = sqrtf(f0);
  eta = (1.0f + eta) / (1.0f - eta);
  const float sin_i = sqrtf(sat01(1.0f - v_dot_h * v_dot_h));
  const float sin_t = sin_i / fmaxf(eta, 1e-8f);
  const float cos_t = sqrtf(fmaxf(1.0f - sin_t * sin_t, 0.0f));
  const float rs = (v_dot_h - eta * cos_t) / fmaxf(v_dot_h + eta * cos_t, 1e-8f);
  const float rp = (cos_t - eta * v_dot_h) / fmaxf(cos_t + eta * v_dot_h, 1e-8f);
  return sat01((rs * rs + rp * rp) * 0.5f);
}

__device__ __forceinline__ float lambda_smith(float n_dot_x, float alpha2) {
  const float x2 = fmaxf(n_dot_x * n_dot_x, 1e-12f);
  return (-1.0f + sqrtf((alpha2 * (1.0f - x2)) / x2 + 1.0f)) * 0.5f;
}

// GGX-Smith specular; alpha2 is float32(roughness^2) and a_minus_1 the
// float32 alpha2 - 1 of the twin (a Python double for the land's constant
// roughness, a float32 tensor op for the ocean's).
__device__ __forceinline__ float ggx_smith_specular(float alpha2, float a_minus_1, float f0,
                                                    float ndl, float ndv, float ldh,
                                                    float ndh) {
  const float den = (a_minus_1 * ndh) * ndh + 1.0f;
  const float d = alpha2 / ((PY(PI_D) * den) * den);
  const float g = 1.0f / ((1.0f + lambda_smith(ndv, alpha2)) + lambda_smith(ndl, alpha2));
  const float f = fresnel_dielectric(ldh, f0);
  return ((d * g) * f) / fmaxf((4.0f * ndl) * ndv, 1e-5f);
}

__device__ __forceinline__ float beckmann_specular(float roughness, float f0, float ndl,
                                                   float ndv, float ldh, float ndh) {
  const float alpha = (roughness * roughness) * 2.0f;
  const float c2 = fmaxf(ndh * ndh, 1e-12f);
  const float alpha2 = alpha * alpha;
  const float exponent = (1.0f - c2) / (alpha2 * c2);
  const float denom = ((PY(PI_D) * alpha2) * c2) * c2;
  const float d = expf(-exponent) / fmaxf(denom, 1e-5f);
  const float vdh = fmaxf(ldh, 1e-8f);
  const float v = fminf(fminf(((2.0f * ndv) * ndh) / vdh, ((2.0f * ndl) * ndh) / vdh), 1.0f);
  return (d * v) * fresnel_dielectric(ldh, f0);
}

struct BrdfParts {
  float diffuse, specular, n_dot_l;  // brdf = albedo * diffuse + specular
};

// Albedo-independent Earth BRDF: Disney diffuse + land GGX / ocean
// Beckmann-GGX blend.
__device__ __forceinline__ BrdfParts earth_brdf_parts(float ocean, float bathymetry, V3 v,
                                                      V3 n, V3 l) {
  const V3 h = normalize3(V3{v.x + l.x, v.y + l.y, v.z + l.z});
  const float ndl = sat01(dot(n, l));
  const float ndv = sat01(dot(n, v));
  const float ldh = sat01(dot(l, h));
  const float ndh = sat01(dot(n, h));

  const float ocean_rough =
      PY(0.23 + 0.02) + PY((0.23 - 0.04) - (0.23 + 0.02)) * smoothstep_py(0.3, 0.7, bathymetry);
  // Disney diffuse at the land roughness 0.73
  const float r_r = PY(2.0 * 0.73) * (ldh * ldh);
  const float f_l = powf(1.0f - ndl, 5.0f);
  const float f_v = powf(1.0f - ndv, 5.0f);
  const float f_retro = (PY(1.0 / PI_D) * r_r) * ((f_l + f_v) + (f_l * f_v) * (r_r - 1.0f));
  const float diffuse = (PY(1.0 / PI_D) * (1.0f - 0.5f * f_l)) * (1.0f - 0.5f * f_v) + f_retro;

  const float land_spec = ggx_smith_specular(PY(0.73 * 0.73), PY(0.73 * 0.73 - 1.0), PY(0.04),
                                             ndl, ndv, ldh, ndh);
  const float oa2 = ocean_rough * ocean_rough;
  const float ocean_ggx = ggx_smith_specular(oa2, oa2 - 1.0f, PY(0.02), ndl, ndv, ldh, ndh);
  const float ocean_beck = 0.65f * beckmann_specular(ocean_rough, PY(0.02), ndl, ndv, ldh, ndh);
  const float t = fminf(fmaxf(smoothstep_py(0.2, 0.95, ndv), 0.05f), 0.94f);
  const float ocean_spec = ocean_beck + (ocean_ggx - ocean_beck) * t;
  const float blend = smoothstep_py(0.6, 1.0, ocean);
  BrdfParts out;
  out.diffuse = diffuse * PY(0.28);
  out.specular = (land_spec + (ocean_spec - land_spec) * blend) * 0.5f;
  out.n_dot_l = ndl;
  return out;
}

// --- samplers -------------------------------------------------------------

// Uniform direction in the cone of cos_max about axis n.
__device__ __forceinline__ V3 sample_cone_oriented(float u0, float u1, float cos_max, V3 n) {
  const float cos_t = (1.0f - u0) + u0 * cos_max;
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const float phi = PY(2.0 * PI_D) * u1;
  const float l0 = sin_t * cosf(phi), l1 = sin_t * sinf(phi);
  V3 x, y;
  orthonormal_basis(n, x, y);
  return V3{(l0 * x.x + l1 * y.x) + cos_t * n.x, (l0 * x.y + l1 * y.y) + cos_t * n.y,
            (l0 * x.z + l1 * y.z) + cos_t * n.z};
}

// Cosine-weighted hemisphere about n (Shirley's offset sphere).
__device__ __forceinline__ V3 sample_hemisphere_cosine_weighted(float u0, float u1, V3 n) {
  float a = 1.0f - 2.0f * u0;
  float b = sqrtf(fmaxf(1.0f - a * a, 0.0f));
  a = a * PY(1.0 - 1e-5);
  b = b * PY(1.0 - 1e-5);
  const float phi = PY(2.0 * PI_D) * u1;
  return normalize3(V3{n.x + b * cosf(phi), n.y + b * sinf(phi), n.z + a});
}

}  // namespace de
