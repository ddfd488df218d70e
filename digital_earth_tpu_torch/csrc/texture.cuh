// Equirect taps of a uint8 (H, W, C) texture, with the conventions of
// digital_earth_tpu/ops/texture.py:13-17 and :184-226: texel centres at
// (i + 0.5)/N, u wraps, v clamps, row 0 is the north pole, value/255;
// nearest rounds half to even, bilinear is an explicit float32 lerp. A
// nearest tap of a 4-channel texture is one 32-bit read.
#pragma once
#include <cstdint>

#include "atmosphere.cuh"

namespace de {

// float32(math.pi)
constexpr float PI_F = 3.14159265358979323846f;
// The port's sphere_uv_map divides by the Python float pi, which PyTorch's
// CUDA ops apply as a multiply by its float32 reciprocal.
constexpr float INV_PI_F = 1.0f / PI_F;

// Texel i of a 4-channel texture in one 32-bit read, channel c in bits
// 8c to 8c + 7. The base must be 4-byte aligned: every wrapper that passes
// a 4-channel texture refuses one that is not.
__device__ __forceinline__ uint32_t texel4(const uint8_t* __restrict__ tex, size_t i) {
  return __ldg(reinterpret_cast<const uint32_t*>(tex) + i);
}

// sample_equirect at (u, v): bilinear (the float32 lerp in the plain
// version's order) or nearest.
template <int C>
__device__ __forceinline__ void equirect_tap(const uint8_t* __restrict__ tex, int H, int W,
                                             float u, float v, bool bilinear, float out[C]) {
  const float x = u * (float)W - 0.5f;
  const float y = fminf(fmaxf((1.0f - v) * (float)H - 0.5f, 0.0f), (float)H - 1.0f);
  if (!bilinear) {
    int ix = (int)rintf(x) % W;
    if (ix < 0) ix += W;
    const int iy = min(max((int)rintf(y), 0), H - 1);
    const size_t i = (size_t)iy * W + ix;
    if constexpr (C == 4) {
      const uint32_t w = texel4(tex, i);
#pragma unroll
      for (int c = 0; c < C; ++c) out[c] = (float)((w >> (8 * c)) & 0xFFu) * (1.0f / 255.0f);
    } else {
      const uint8_t* t = tex + i * C;
#pragma unroll
      for (int c = 0; c < C; ++c) out[c] = (float)t[c] * (1.0f / 255.0f);
    }
    return;
  }
  const float x0f = floorf(x), y0f = floorf(y);
  const float tx = x - x0f, ty = y - y0f;
  int x0 = (int)x0f % W;
  if (x0 < 0) x0 += W;
  const int x1 = (x0 + 1) % W;
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int y1 = min(y0 + 1, H - 1);
  const uint8_t* t00 = tex + ((size_t)y0 * W + x0) * C;
  const uint8_t* t10 = tex + ((size_t)y0 * W + x1) * C;
  const uint8_t* t01 = tex + ((size_t)y1 * W + x0) * C;
  const uint8_t* t11 = tex + ((size_t)y1 * W + x1) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float v00 = (float)t00[c] * (1.0f / 255.0f), v10 = (float)t10[c] * (1.0f / 255.0f);
    const float v01 = (float)t01[c] * (1.0f / 255.0f), v11 = (float)t11[c] * (1.0f / 255.0f);
    out[c] = (v00 * (1.0f - tx) + v10 * tx) * (1.0f - ty) + (v01 * (1.0f - tx) + v11 * tx) * ty;
  }
}

// Nearest tap at the direction of p, as the trackers take it (the angles
// divided by pi).
template <int C>
__device__ __forceinline__ void sphere_tap_nearest(
    const uint8_t* __restrict__ tex, int H, int W, V3 p, float out[C]) {
  const float l = fmaxf(length(p), 1e-20f);
  const float nx = p.x / l, ny = p.y / l, nz = p.z / l;
  const float u = (atan2f(nz, -nx) / PI_F + 1.0f) / 2.0f;
  const float v = asinf(fminf(fmaxf(ny, -1.0f), 1.0f)) / PI_F + 0.5f;
  equirect_tap<C>(tex, H, W, u, v, false, out);
}

// ops/texture.sample_sphere_texture at p as the port's twin computes it on
// the card: normalize(p), the angles times float32(1/pi), then the bilinear
// (or nearest) tap.
template <int C>
__device__ __forceinline__ void sphere_tap(const uint8_t* __restrict__ tex, int H, int W, V3 p,
                                           bool bilinear, float out[C]) {
  const float l = fmaxf(length(p), 1e-20f);
  const float nx = p.x / l, ny = p.y / l, nz = p.z / l;
  const float u = (atan2f(nz, -nx) * INV_PI_F + 1.0f) * 0.5f;
  const float v = asinf(fminf(fmaxf(ny, -1.0f), 1.0f)) * INV_PI_F + 0.5f;
  equirect_tap<C>(tex, H, W, u, v, bilinear, out);
}

// ops/texture.sample_dir_texture: the tap at unit direction (dx, dy, dz),
// bilinear (sample_equirect's float32 lerp) or nearest.
template <int C>
__device__ __forceinline__ void dir_tap(const uint8_t* __restrict__ tex, int H, int W,
                                        float dx, float dy, float dz, bool bilinear,
                                        float out[C]) {
  const float u = (atan2f(dz, -dx) / PI_F + 1.0f) / 2.0f;
  const float v = asinf(fminf(fmaxf(dy, -1.0f), 1.0f)) / PI_F + 0.5f;
  equirect_tap<C>(tex, H, W, u, v, bilinear, out);
}

}  // namespace de
