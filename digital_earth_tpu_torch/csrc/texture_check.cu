// Test-only launcher for texture.cuh's sphere tap: out[i, :] = the
// (bilinear or nearest) tap of a uint8 (H, W, C) texture at the direction of
// pos[i], as the bounce kernel takes its topography and material taps.
// chip_smoke.py and the card tests hold it against the plain
// ops/texture.sample_sphere_texture; it is not on the render path. Each mode
// is its own instance, so chip_smoke.py reads the SASS of a nearest tap
// alone.
#include <cstdint>

#include <cuda_runtime.h>

#include "texture.cuh"

namespace de {

template <int C, bool BILINEAR>
__global__ void sphere_tap_kernel(const uint8_t* __restrict__ tex, int H, int W,
                                  const float* __restrict__ pos, int n,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[C];
  sphere_tap<C>(tex, H, W, load3(pos, i), BILINEAR, v);
#pragma unroll
  for (int c = 0; c < C; ++c) out[(size_t)i * C + c] = v[c];
}

template <int C>
void launch_sphere_tap(const uint8_t* tex, int H, int W, const float* pos, int n, int bilinear,
                       float* out, cudaStream_t stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (bilinear) {
    sphere_tap_kernel<C, true><<<grid, block, 0, stream>>>(tex, H, W, pos, n, out);
  } else {
    sphere_tap_kernel<C, false><<<grid, block, 0, stream>>>(tex, H, W, pos, n, out);
  }
}

}  // namespace de

// tex (H, W, C) uint8 with C 4 or 8, pos (n, 3) -> out (n, C).
extern "C" int de_sphere_tap(const uint8_t* tex, int H, int W, int C, const float* pos, int n,
                             int bilinear, float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (C == 4) {
    de::launch_sphere_tap<4>(tex, H, W, pos, n, bilinear, out, (cudaStream_t)stream);
  } else if (C == 8) {
    de::launch_sphere_tap<8>(tex, H, W, pos, n, bilinear, out, (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
