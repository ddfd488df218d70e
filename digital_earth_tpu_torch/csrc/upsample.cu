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
// Work split: a block owns one base row ys and one segment of SEG bytes of
// its output rows ys f ... ys f + f - 1, which are the same bytes but for the
// jitter. It stages the base bytes the segment reads in shared memory; each
// thread then builds 16-byte chunks of the output row there once (output
// byte b is base byte ((b / C) / f) C + b % C, all in 32 bits: C a template
// parameter, f a multiply-high divisor of fast_div.cuh) and writes each
// chunk to the f rows with 16-byte streaming stores (st.global.cs), hashing
// only the jittered channel's bytes per row. A row of W C bytes that is not
// a multiple of 16 (odd shapes) takes the byte path: one byte per thread
// and segment position, f byte stores.
//
// What bounds it on the H100: bytes written. The tier-2 atlas (four planes
// of 8, 4, 4 and 3 channels at 21600x10800) writes 4.43e9 bytes, 1.32 ms at
// 3.35 TB/s; the streaming stores keep that stream from sweeping the 50 MB
// L2. The hash is ~16 integer and float operations per jittered texel.
#include <cstdint>

#include <cuda_runtime.h>

#include "fast_div.cuh"

namespace de {

constexpr int UP_THREADS = 256;
constexpr int UP_CHUNKS = 4;                               // 16-byte chunks per thread
constexpr uint32_t UP_SEG = UP_THREADS * UP_CHUNKS * 16;  // output-row bytes per block
constexpr uint32_t UP_STAGE = UP_SEG + 16;                 // >= the base bytes a segment reads

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t jittered(uint32_t v, uint32_t id, float jitter,
                                             uint32_t seed) {
  const float u = __uint2float_rn(lowbias32(id ^ seed)) * 2.3283064365386963e-10f;
  return (uint32_t)(uint8_t)rintf((float)v * (1.0f - jitter * u));
}

struct UpsampleArgs {
  const uint8_t* base;
  uint8_t* out;
  uint32_t w, f, W, row;  // base width, factor, output width, output row bytes (W C)
  FastDiv fdiv;
  int jc;  // jittered channel, -1 for none
  float jitter;
  uint32_t seed;
};

// Stage the base bytes of segment [b0, b1) of row ys: base texels xs_lo ..
// (the texel of byte b1 - 1); returns xs_lo.
template <int C>
__device__ __forceinline__ uint32_t stage_base(const UpsampleArgs& a, uint32_t ys,
                                               uint32_t b0, uint32_t b1, uint8_t* sm) {
  const uint32_t xs_lo = fast_div(a.fdiv, b0 / C);
  const uint32_t xs_hi = fast_div(a.fdiv, (b1 - 1) / C);
  const uint32_t n = (xs_hi - xs_lo + 1) * C;
  const uint8_t* __restrict__ src = a.base + ((size_t)ys * a.w + xs_lo) * C;
  for (uint32_t i = threadIdx.x; i < n; i += UP_THREADS) sm[i] = src[i];
  __syncthreads();
  return xs_lo;
}

// The vector path: W C a multiple of 16, so every output row starts on a
// 16-byte boundary and holds whole chunks.
template <int C>
__global__ void __launch_bounds__(UP_THREADS) upsample_rows(UpsampleArgs a) {
  __shared__ __align__(16) uint8_t sm[UP_STAGE];
  const uint32_t ys = blockIdx.x;
  const uint32_t b0 = blockIdx.y * UP_SEG;
  const uint32_t b1 = min(b0 + UP_SEG, a.row);
  const uint32_t xs_lo = stage_base<C>(a, ys, b0, b1, sm);
  const uint32_t y0 = ys * a.f;
  for (uint32_t q = b0 / 16 + threadIdx.x; q < b1 / 16; q += UP_THREADS) {
    // the chunk's first texel x0 and channel c0; then byte by byte
    const uint32_t x0 = (q * 16) / C;
    const uint32_t c0 = q * 16 - x0 * C;  // 0 when C divides 16: a constant
    const uint32_t xs0 = fast_div(a.fdiv, x0);
    uint32_t word[4] = {0u, 0u, 0u, 0u};
    {
      uint32_t c = (16 % C == 0) ? 0u : c0, xs = xs0, fx = x0 - xs0 * a.f;
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        word[p >> 2] |= (uint32_t)sm[(xs - xs_lo) * C + c] << (8 * (p & 3));
        if (++c == C) {
          c = 0;
          if (++fx == a.f) {
            fx = 0;
            ++xs;
          }
        }
      }
    }
    uint8_t* __restrict__ dst = a.out + (size_t)y0 * a.row + q * 16;
    for (uint32_t r = 0; r < a.f; ++r, dst += a.row) {
      uint4 v = make_uint4(word[0], word[1], word[2], word[3]);
      if (a.jc >= 0) {
        uint32_t o[4] = {v.x, v.y, v.z, v.w};
        const uint32_t id0 = (y0 + r) * a.W + x0;  // uint32 texel id, wrapping as the twin's
        uint32_t c = (16 % C == 0) ? 0u : c0, dx = 0;
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          if (c == (uint32_t)a.jc) {
            const int s = 8 * (p & 3);
            const uint32_t byte = jittered((o[p >> 2] >> s) & 0xFFu, id0 + dx, a.jitter, a.seed);
            o[p >> 2] = (o[p >> 2] & ~(0xFFu << s)) | (byte << s);
          }
          if (++c == C) {
            c = 0;
            ++dx;
          }
        }
        v = make_uint4(o[0], o[1], o[2], o[3]);
      }
      __stcs(reinterpret_cast<uint4*>(dst), v);
    }
  }
}

// The byte path: any W C (odd shapes), one output byte per thread and
// segment position.
template <int C>
__global__ void __launch_bounds__(UP_THREADS) upsample_bytes(UpsampleArgs a) {
  __shared__ __align__(16) uint8_t sm[UP_STAGE];
  const uint32_t ys = blockIdx.x;
  const uint32_t b0 = blockIdx.y * UP_SEG;
  const uint32_t b1 = min(b0 + UP_SEG, a.row);
  const uint32_t xs_lo = stage_base<C>(a, ys, b0, b1, sm);
  const uint32_t y0 = ys * a.f;
  for (uint32_t b = b0 + threadIdx.x; b < b1; b += UP_THREADS) {
    const uint32_t x = b / C;
    const uint32_t c = b - x * C;
    const uint32_t v = sm[(fast_div(a.fdiv, x) - xs_lo) * C + c];
    const bool jit = (int)c == a.jc;
    uint8_t* __restrict__ dst = a.out + (size_t)y0 * a.row + b;
    for (uint32_t r = 0; r < a.f; ++r, dst += a.row)
      *dst = (uint8_t)(jit ? jittered(v, (y0 + r) * a.W + x, a.jitter, a.seed) : v);
  }
}

template <int C>
int launch(const UpsampleArgs& a, uint32_t h, cudaStream_t stream) {
  const dim3 grid(h, (a.row + UP_SEG - 1) / UP_SEG);
  if (a.row % 16 == 0)
    upsample_rows<C><<<grid, UP_THREADS, 0, stream>>>(a);
  else
    upsample_bytes<C><<<grid, UP_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace de

// base (h, w, C) uint8 -> out (h f, w f, C) uint8, n = h f * w f texels.
// jc is the jittered channel, or -1 for none (jitter <= 0 or jc outside
// [0, C)); jitter is float32(jitter), seed the 32-bit jitter seed. An output
// row (w f C bytes) must stay under 2^31 bytes and the segments of a row
// under 65536; out must be 16-byte aligned (PyTorch's allocations are).
extern "C" int de_upsample(const uint8_t* base, int w, int C, int f, uint8_t* out, int64_t n,
                           int jc, float jitter, uint32_t seed, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t W = (int64_t)w * f;
  const int64_t row = W * C;
  const int64_t h = n / W / f;
  if (w <= 0 || f <= 0 || row >= (1ll << 31) || h > 0x7FFFFFFF ||
      (row + de::UP_SEG - 1) / de::UP_SEG > 65535 || ((uintptr_t)out & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const de::UpsampleArgs a{base, out, (uint32_t)w, (uint32_t)f, (uint32_t)W, (uint32_t)row,
                           de::make_fast_div((uint32_t)f), jc, jitter, seed};
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return de::launch<1>(a, (uint32_t)h, s);
    case 2: return de::launch<2>(a, (uint32_t)h, s);
    case 3: return de::launch<3>(a, (uint32_t)h, s);
    case 4: return de::launch<4>(a, (uint32_t)h, s);
    case 5: return de::launch<5>(a, (uint32_t)h, s);
    case 6: return de::launch<6>(a, (uint32_t)h, s);
    case 7: return de::launch<7>(a, (uint32_t)h, s);
    case 8: return de::launch<8>(a, (uint32_t)h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
