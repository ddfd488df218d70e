// Test-only launcher for texture.cuh's sphere tap: out[i, :] = the
// (bilinear or nearest) tap of a uint8 (H, W, C) texture at the direction of
// pos[i], as the bounce kernel takes its topography and material taps.
// chip_smoke.py and the card tests hold it against the plain
// ops/texture.sample_sphere_texture; it is not on the render path.
#include <cstdint>

#include <cuda_runtime.h>

#include "texture.cuh"

namespace de {

template <int C>
__global__ void sphere_tap_kernel(const uint8_t* __restrict__ tex, int H, int W,
                                  const float* __restrict__ pos, int n, int bilinear,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[C];
  sphere_tap<C>(tex, H, W, load3(pos, i), bilinear != 0, v);
#pragma unroll
  for (int c = 0; c < C; ++c) out[(size_t)i * C + c] = v[c];
}

}  // namespace de

// tex (H, W, C) uint8 with C 4 or 8, pos (n, 3) -> out (n, C).
extern "C" int de_sphere_tap(const uint8_t* tex, int H, int W, int C, const float* pos, int n,
                             int bilinear, float* out, void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (n <= 0) return (int)cudaGetLastError();
  if (C == 4) {
    de::sphere_tap_kernel<4><<<grid, block, 0, (cudaStream_t)stream>>>(tex, H, W, pos, n,
                                                                       bilinear, out);
  } else if (C == 8) {
    de::sphere_tap_kernel<8><<<grid, block, 0, (cudaStream_t)stream>>>(tex, H, W, pos, n,
                                                                       bilinear, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
