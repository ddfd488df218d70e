// Test-only launchers for texture.cuh's taps: out[i, :] = the (bilinear or
// nearest) tap of a uint8 (H, W, C) texture at the direction of pos[i], as
// the bounce kernel takes its topography and material taps (sphere_tap), or
// at the unit direction dir[i], as frame_end and preview take the stars
// (dir_tap). chip_smoke.py and the card tests hold them against the plain
// ops/texture.sample_sphere_texture and sample_dir_texture; they are not on
// the render path. Each mode is its own instance, so chip_smoke.py reads the
// SASS of a nearest tap alone. A third mode taps by the bilinear form that
// texture.cuh first had (a byte load and an I2F a channel, two remainders by
// W; equirect_bilinear_first below, kept here alone), so that the card holds
// texture.cuh's bilinear branch bit for bit against it and chip_smoke.py
// keeps that form's SASS as the bilinear tap's work (PERF.md row 2o).
#include <cstdint>

#include <cuda_runtime.h>

#include "texture.cuh"

namespace de {

enum { TAP_NEAREST, TAP_BILINEAR, TAP_BILINEAR_FIRST };

// A tap's C floats to out[i, :]: as 16-byte stores where C is a multiple of
// 4 (the wrappers' outputs come from torch.empty, 16-byte aligned), a store
// a channel otherwise. Written a channel at a time, the 8 floats of a
// material tap took 8 strided stores a point, which set the launcher's
// time and hid the tap's.
template <int C>
__device__ __forceinline__ void store_tap(float* __restrict__ out, int i, const float v[C]) {
  if constexpr (C % 4 == 0) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)i * C);
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) out[(size_t)i * C + c] = v[c];
  }
}

// equirect_tap's bilinear branch as first written.
template <int C>
__device__ __forceinline__ void equirect_bilinear_first(const uint8_t* __restrict__ tex, int H,
                                                        int W, float u, float v, float out[C]) {
  const float x = u * (float)W - 0.5f;
  const float y = fminf(fmaxf((1.0f - v) * (float)H - 0.5f, 0.0f), (float)H - 1.0f);
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

// sphere_tap's angles, then the first bilinear form.
template <int C>
__device__ __forceinline__ void sphere_tap_first(const uint8_t* __restrict__ tex, int H, int W,
                                                 V3 p, float out[C]) {
  const float l = fmaxf(length(p), 1e-20f);
  const float nx = p.x / l, ny = p.y / l, nz = p.z / l;
  const float u = (atan2f(nz, -nx) * INV_PI_F + 1.0f) * 0.5f;
  const float v = asinf(fminf(fmaxf(ny, -1.0f), 1.0f)) * INV_PI_F + 0.5f;
  equirect_bilinear_first<C>(tex, H, W, u, v, out);
}

// dir_tap's angles, then the first bilinear form.
template <int C>
__device__ __forceinline__ void dir_tap_first(const uint8_t* __restrict__ tex, int H, int W,
                                              float dx, float dy, float dz, float out[C]) {
  const float u = (atan2f(dz, -dx) / PI_F + 1.0f) / 2.0f;
  const float v = asinf(fminf(fmaxf(dy, -1.0f), 1.0f)) / PI_F + 0.5f;
  equirect_bilinear_first<C>(tex, H, W, u, v, out);
}

template <int C, bool BILINEAR>
__global__ void sphere_tap_kernel(const uint8_t* __restrict__ tex, int H, int W,
                                  const float* __restrict__ pos, int n,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[C];
  sphere_tap<C>(tex, H, W, load3(pos, i), BILINEAR, v);
  store_tap<C>(out, i, v);
}

template <int C>
__global__ void sphere_tap_first_kernel(const uint8_t* __restrict__ tex, int H, int W,
                                        const float* __restrict__ pos, int n,
                                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[C];
  sphere_tap_first<C>(tex, H, W, load3(pos, i), v);
  store_tap<C>(out, i, v);
}

template <int C, bool BILINEAR>
__global__ void dir_tap_kernel(const uint8_t* __restrict__ tex, int H, int W,
                               const float* __restrict__ dir, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[C];
  const V3 d = load3(dir, i);
  dir_tap<C>(tex, H, W, d.x, d.y, d.z, BILINEAR, v);
  store_tap<C>(out, i, v);
}

template <int C>
__global__ void dir_tap_first_kernel(const uint8_t* __restrict__ tex, int H, int W,
                                     const float* __restrict__ dir, int n,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[C];
  const V3 d = load3(dir, i);
  dir_tap_first<C>(tex, H, W, d.x, d.y, d.z, v);
  store_tap<C>(out, i, v);
}

template <int C>
void launch_sphere_tap(const uint8_t* tex, int H, int W, const float* pos, int n, int mode,
                       float* out, cudaStream_t stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (mode == TAP_BILINEAR) {
    sphere_tap_kernel<C, true><<<grid, block, 0, stream>>>(tex, H, W, pos, n, out);
  } else if (mode == TAP_BILINEAR_FIRST) {
    sphere_tap_first_kernel<C><<<grid, block, 0, stream>>>(tex, H, W, pos, n, out);
  } else {
    sphere_tap_kernel<C, false><<<grid, block, 0, stream>>>(tex, H, W, pos, n, out);
  }
}

}  // namespace de

// tex (H, W, C) uint8 with C 4 or 8, pos (n, 3) -> out (n, C); mode 0
// nearest, 1 bilinear, 2 the first bilinear form.
extern "C" int de_sphere_tap(const uint8_t* tex, int H, int W, int C, const float* pos, int n,
                             int mode, float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (C == 4) {
    de::launch_sphere_tap<4>(tex, H, W, pos, n, mode, out, (cudaStream_t)stream);
  } else if (C == 8) {
    de::launch_sphere_tap<8>(tex, H, W, pos, n, mode, out, (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// tex (H, W, 3) uint8 (the stars), dir (n, 3) unit directions -> out (n,
// 3); mode as de_sphere_tap's.
extern "C" int de_dir_tap(const uint8_t* tex, int H, int W, int C, const float* dir, int n,
                          int mode, float* out, void* stream) {
  if (C != 3) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int block = 128;
  const int grid = (n + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == de::TAP_BILINEAR) {
    de::dir_tap_kernel<3, true><<<grid, block, 0, st>>>(tex, H, W, dir, n, out);
  } else if (mode == de::TAP_BILINEAR_FIRST) {
    de::dir_tap_first_kernel<3><<<grid, block, 0, st>>>(tex, H, W, dir, n, out);
  } else {
    de::dir_tap_kernel<3, false><<<grid, block, 0, st>>>(tex, H, W, dir, n, out);
  }
  return (int)cudaGetLastError();
}
