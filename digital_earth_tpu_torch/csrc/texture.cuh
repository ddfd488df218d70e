// Equirect taps of a uint8 (H, W, C) texture, with the conventions of
// digital_earth_tpu/ops/texture.py:13-17 and :184-226: texel centres at
// (i + 0.5)/N, u wraps, v clamps, row 0 is the north pole, value/255;
// nearest rounds half to even, bilinear is an explicit float32 lerp. A
// nearest tap of a 4-channel texture is one 32-bit read. A bilinear tap
// reads each of its four texels in one word (32 bits at C = 4, 64 at C = 8;
// a byte a channel otherwise), turns each byte into a float without the XU
// pipe's conversions (byte_float) and wraps u with a compare and a select.
// Its first form, a byte load and an I2F a channel and two remainders by W,
// ran at 0.28 of its operations bound, which the XU pipe's 30 instructions a
// tap set (PERF.md row 2o).
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

// Texel i of an 8-channel texture in one 64-bit read, channels 0-3 in .x
// and 4-7 in .y. The base must be 8-byte aligned: every wrapper that passes
// an 8-channel texture refuses one that is not.
__device__ __forceinline__ uint2 texel8(const uint8_t* __restrict__ tex, size_t i) {
  return __ldg(reinterpret_cast<const uint2*>(tex) + i);
}

// (float)b exactly for the byte b in bits 0-7 of v (the rest 0): b as the
// low mantissa of 2^23, less 2^23; a LOP3 and an FADD, no I2F.
__device__ __forceinline__ float low_byte_float(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

// (float) of byte c of the word w, exactly: one PRMT puts the byte under
// 2^23's exponent, one FADD takes 2^23 away. The selector is the PRMT's
// immediate and 2^23's bits a register shared by every channel (with the
// operands the other way round the compiler moved each selector into a
// register first: 34 more instructions an 8-channel tap).
__device__ __forceinline__ float byte_float(uint32_t w, int c) {
  return __uint_as_float(__byte_perm(0x4B000000u, w, 0x3004u + (uint32_t)c)) - 8388608.0f;
}

// Texel i of a C-channel texture as value/255, channel by channel: one
// 32-bit read at C = 4, one 64-bit read at C = 8, a byte read a channel at
// any other C (the stars' 3).
template <int C>
__device__ __forceinline__ void texel_floats(const uint8_t* __restrict__ tex, size_t i,
                                             float v[C]) {
  if constexpr (C == 4) {
    const uint32_t w = texel4(tex, i);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = byte_float(w, c) * (1.0f / 255.0f);
  } else if constexpr (C == 8) {
    const uint2 w = texel8(tex, i);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = byte_float(w.x, c) * (1.0f / 255.0f);
      v[c + 4] = byte_float(w.y, c) * (1.0f / 255.0f);
    }
  } else {
    const uint8_t* t = tex + i * C;
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = low_byte_float(__ldg(t + c)) * (1.0f / 255.0f);
  }
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
  // Every caller takes u from an atan2 (sphere_tap, sphere_tap_nearest,
  // dir_tap), so u lies in [0, 1] and x0f in [-1, W - 1], or u is NaN and
  // (int)x0f 0: there the remainders (int)x0f % W (+ W below 0) and
  // (x0 + 1) % W are a compare and a select each.
  int x0 = (int)x0f;
  if (x0 < 0) x0 += W;
  const int x1 = x0 + 1 < W ? x0 + 1 : 0;
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int y1 = min(y0 + 1, H - 1);
  const size_t r0 = (size_t)y0 * W, r1 = (size_t)y1 * W;
  float v00[C], v10[C], v01[C], v11[C];
  texel_floats<C>(tex, r0 + x0, v00);
  texel_floats<C>(tex, r0 + x1, v10);
  texel_floats<C>(tex, r1 + x0, v01);
  texel_floats<C>(tex, r1 + x1, v11);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    out[c] = (v00[c] * (1.0f - tx) + v10[c] * tx) * (1.0f - ty) +
             (v01[c] * (1.0f - tx) + v11[c] * tx) * ty;
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
