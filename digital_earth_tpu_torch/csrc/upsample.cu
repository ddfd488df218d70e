// upsample: nearest-neighbour upsample of a uint8 (h, w, C) image by an
// integer factor f into (h f, w f, C), with an optional per-texel downward
// jitter of one channel.
//
// Replaces the TPU stage digital_earth_tpu/ops/texture.py:74-148
// Tex2D.from_upsampled (its jitted _up_pack), which repeats the image in
// transpose space and packs it into the TPU's (n_rows, 128) row-gather
// layout. The port keeps textures as plain (H, W, C) tensors, so the kernel
// writes the image itself. Output texel id = y W + x (as uint32) feeds the
// lowbias32 hash (Walker 2018) with the seed, u = float(hash) 2^-32 in
// [0, 1), and channel jc of that texel becomes
// rint(float(v) * (1 - jitter * u)) (round half to even), exactly as the
// reference's packed lanes compute it for the same texel id; the plain twin
// is ops/texture.upsample_plain.
//
// Work split: one thread per output texel over a 64-bit texel index (a
// 21600x10800x8 plane is 1.87e9 bytes); it reads its base texel (the base is
// 1/f^2 of the output and stays in L2) and writes its C bytes; only the
// jitter channel is hashed and scaled.
//
// What bounds it on the H100: bytes written. The tier-2 atlas (four planes
// of 8, 4, 4 and 3 channels at 21600x10800) writes 4.43e9 bytes, 1.32 ms at
// 3.35 TB/s; the hash is ~12 integer operations per jittered texel.
#include <cstdint>

#include <cuda_runtime.h>

namespace de {

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

template <int C>
__global__ void upsample_kernel(const uint8_t* __restrict__ base, int w, int f,
                                uint8_t* __restrict__ out, int64_t n, int jc, float jitter,
                                uint32_t seed) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t W = (int64_t)w * f;
  const int64_t y = i / W;
  const int64_t x = i - y * W;
  const uint8_t* __restrict__ s = base + ((y / f) * w + x / f) * C;
  uint8_t* __restrict__ o = out + i * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = s[c];
  if (jc >= 0) {
    const float u = __uint2float_rn(lowbias32((uint32_t)i ^ seed)) * 2.3283064365386963e-10f;
    o[jc] = (uint8_t)rintf((float)s[jc] * (1.0f - jitter * u));
  }
}

template <int C>
int launch(const uint8_t* base, int w, int f, uint8_t* out, int64_t n, int jc, float jitter,
           uint32_t seed, cudaStream_t stream) {
  const int block = 256;
  const int64_t grid = (n + block - 1) / block;
  upsample_kernel<C><<<(unsigned)grid, block, 0, stream>>>(base, w, f, out, n, jc, jitter, seed);
  return (int)cudaGetLastError();
}

}  // namespace de

// base (h, w, C) uint8 -> out (h f, w f, C) uint8, n = h f * w f texels.
// jc is the jittered channel, or -1 for none (jitter <= 0 or jc outside
// [0, C)); jitter is float32(jitter), seed the 32-bit jitter seed.
extern "C" int de_upsample(const uint8_t* base, int w, int C, int f, uint8_t* out, int64_t n,
                           int jc, float jitter, uint32_t seed, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if ((n + 255) / 256 > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return de::launch<1>(base, w, f, out, n, jc, jitter, seed, s);
    case 2: return de::launch<2>(base, w, f, out, n, jc, jitter, seed, s);
    case 3: return de::launch<3>(base, w, f, out, n, jc, jitter, seed, s);
    case 4: return de::launch<4>(base, w, f, out, n, jc, jitter, seed, s);
    case 5: return de::launch<5>(base, w, f, out, n, jc, jitter, seed, s);
    case 6: return de::launch<6>(base, w, f, out, n, jc, jitter, seed, s);
    case 7: return de::launch<7>(base, w, f, out, n, jc, jitter, seed, s);
    case 8: return de::launch<8>(base, w, f, out, n, jc, jitter, seed, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
