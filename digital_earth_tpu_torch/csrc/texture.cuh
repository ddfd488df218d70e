// Nearest equirect tap of a uint8 (H, W, C) texture at the direction of a
// position, with the conventions of digital_earth_tpu/ops/texture.py:13-17
// and :184-226: texel centres at (i + 0.5)/N, u wraps, v clamps, row 0 is
// the north pole, round half to even, value/255.
#pragma once
#include <cstdint>

#include "atmosphere.cuh"

namespace de {

// float32(math.pi)
constexpr float PI_F = 3.14159265358979323846f;

template <int C>
__device__ __forceinline__ void sphere_tap_nearest(
    const uint8_t* __restrict__ tex, int H, int W, V3 p, float out[C]) {
  const float l = fmaxf(length(p), 1e-20f);
  const float nx = p.x / l, ny = p.y / l, nz = p.z / l;
  const float u = (atan2f(nz, -nx) / PI_F + 1.0f) / 2.0f;
  const float v = asinf(fminf(fmaxf(ny, -1.0f), 1.0f)) / PI_F + 0.5f;
  const float x = u * (float)W - 0.5f;
  const float y = fminf(fmaxf((1.0f - v) * (float)H - 0.5f, 0.0f), (float)H - 1.0f);
  int ix = (int)rintf(x) % W;
  if (ix < 0) ix += W;
  const int iy = min(max((int)rintf(y), 0), H - 1);
  const uint8_t* t = tex + ((size_t)iy * W + ix) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = (float)t[c] * (1.0f / 255.0f);
}

}  // namespace de
