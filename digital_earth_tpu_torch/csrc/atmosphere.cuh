// Scene geometry, the analytic RMO density profiles, their monotone
// envelopes and the ray-perigee math, as device functions
// (digital_earth_tpu/models/volume.py:303-348,
// digital_earth_tpu/models/atmosphere_lut.py:245-252, 385-411).
// Everything rounds op by op (--fmad=false), in the order of the plain
// versions in ops/math_utils.py and models/volume.py; a division by a Python
// constant b there is a multiply by float32(1 / b), the reciprocal taken in
// double, as PyTorch's CUDA ops apply a CPU scalar divisor (volume.cuh).
#pragma once

namespace de {

constexpr float PLANET_R_F = 6371e3f;
constexpr float ATMOS_UPPER_F = 6481e3f;
constexpr float CLOUDS_LOWER_F = 6375e3f;
constexpr float CLOUDS_UPPER_F = 6381e3f;
constexpr float CLOUDS_THICKNESS_F = 6000.0f;
constexpr float CLOUDS_DENSITY_F = 0.029f;
constexpr float MAX_RAY_DIST_F = 63710000.0f;  // 10 planet radii

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* a, int lane) {
  return V3{a[3 * lane], a[3 * lane + 1], a[3 * lane + 2]};
}
__device__ __forceinline__ V3 along(V3 o, float t, V3 d) {
  return V3{o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return a0 * b0 + a1 * b1 + a2 * b2;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }

// The perigee radius's cross product, with fused multiply-adds as
// models/atmosphere_lut._ray_perigee rounds it.
__device__ __forceinline__ float perigee_radius(V3 o, V3 d) {
  const V3 cr{fmaf(o.y, d.z, -(o.z * d.y)), fmaf(o.z, d.x, -(o.x * d.z)),
              fmaf(o.x, d.y, -(o.y * d.x))};
  return length(cr);
}

// Ray-sphere intersection at the origin; (-1, -1) on a miss.
__device__ __forceinline__ void rsi(V3 o, V3 d, float r, float& t_near, float& t_far) {
  const float b = dot(o, d);
  const float c = dot(o, o) - r * r;
  const float discr = b * b - c;
  const float sq = sqrtf(fmaxf(discr, 0.0f));
  const bool miss = discr < 0.0f;
  t_near = miss ? -1.0f : -b - sq;
  t_far = miss ? -1.0f : -b + sq;
}

__device__ __forceinline__ float sq(float x) { return x * x; }

__device__ __forceinline__ float rayl_density(float h) {
  return 3.68082f * expf(-sq(h + 24239.99f) * (float)(1.0 / 532307548.4168)) *
         (float)(1.0 / 1.225);
}

// The twin evaluates all four branches and selects one; here the branch's
// constants are selected first and one expf evaluated (the same operations
// on the same operands for the branch that is kept: the bits of the twin's;
// d_high's "+ 0" is exact, d_high being positive).
__device__ __forceinline__ float mie_density(float h) {
  const bool high = h > 11500.0f, mid = h > 2400.0f, low = h > 1300.0f;
  const float c0 = high ? -11500.0f : mid ? 2500.0f : -1300.0f;
  const float c1 = high ? -1.0e-6f : mid ? -2.5e-9f : -5.0e-6f;
  const float scale = high ? 0.0918f : mid ? 0.3000f : 0.6500f;
  const float add = high ? 0.0f : mid ? -0.092f : 0.18899f;
  const float d_exp = scale * expf(c1 * sq(h + c0)) + add;
  const float d_ground = 1.0f - h * (float)(1.0 / 8136.646);
  const float dens = (high || mid || low) ? d_exp : d_ground;
  return dens * 1.06f;  // TURBIDITY
}

__device__ __forceinline__ float ozone_density(float h) {
  const float h_km = h * 0.001f;
  const float rel = h_km - 25.0f;
  const float rel2 = rel * rel;
  float d = 0.625f * expf(-rel2 * (float)(1.0 / 49.0));
  d = d + 0.375f * expf(-rel2 * (float)(1.0 / 256.0));
  const float c = h_km - 15.0f;
  d = d + fmaxf(-0.000015f * (c * c * c), 0.0f);
  return d;
}

// (rayleigh, mie, ozone) at elevation h, clamped at 0.
__device__ __forceinline__ void get_density(float h, float out[3]) {
  h = fmaxf(h, 0.0f);
  out[0] = rayl_density(h);
  out[1] = mie_density(h);
  out[2] = ozone_density(h);
}

// Per-species env_c(h) >= rho_c(h') for all h' >= h (8 m safety margin).
__device__ __forceinline__ void density_envelope(float h, float o3_env_peak, float out[3]) {
  h = fmaxf(h - 8.0f, 0.0f);
  out[0] = rayl_density(h);
  out[1] = fmaxf(mie_density(h), h <= 11500.0f ? 0.097308f : 0.0f);
  out[2] = h < 25000.0f ? o3_env_peak : ozone_density(h);
}

// Minimum radius over the perigee-frame sub-segment [x_t, x_e].
__device__ __forceinline__ float segment_min_radius(float rp, float x_t, float x_e) {
  const bool spans = (x_t < 0.0f) && (x_e > 0.0f);
  const float end_min = sqrtf(rp * rp + fminf(x_t * x_t, x_e * x_e));
  return spans ? rp : end_min;
}

}  // namespace de
