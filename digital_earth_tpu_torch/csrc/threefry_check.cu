// Test-only launchers for threefry.cuh, each the same numbers as a plain
// function of ops/rng.py; chip_smoke.py holds them bit for bit against it.
// None is on the render path.
//   de_threefry_uniform: out[j, lane] = uniform(fold(key, data), j)
//                        (rng.uniform(rng.fold(keys, data), (count,)));
//   de_threefry_draws:   out[j, lane] = uniform(key, base + j), the counter
//                        mod 2^32, from the key itself (rng.uniform_at), so
//                        that edge keys and counters reach the block;
//   de_threefry_draw_sum: out[lane] = the sum of uniform(key, base + j) for
//                        j < COUNT, 1 or 2, in order. chip_smoke.py counts
//                        the SASS instructions of a draw as those of the
//                        COUNT = 2 kernel less those of the COUNT = 1 (a
//                        key's second word: its block and conversion, and
//                        the sum's FP32 add);
//   de_threefry_fold:    out[lane] = fold^depth(key, data), depth 1 or 2
//                        (rng.fold applied depth times). chip_smoke.py counts
//                        the SASS instructions of one threefry block as those
//                        of the depth-2 kernel less those of the depth-1 (the
//                        two differ by one fold, its key's ks[2] included).
#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace de {

__global__ void threefry_uniform_kernel(const int32_t* __restrict__ keys, int n,
                                        uint32_t data, int count,
                                        float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Key kd = fold(load_key(keys, lane), data);
  for (int j = 0; j < count; ++j) out[(size_t)j * n + lane] = uniform(kd, (uint32_t)j);
}

__global__ void threefry_draws_kernel(const int32_t* __restrict__ keys, int n, uint32_t base,
                                      int count, float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Key k = load_key(keys, lane);
  for (int j = 0; j < count; ++j) out[(size_t)j * n + lane] = uniform(k, base + (uint32_t)j);
}

template <int COUNT>
__global__ void threefry_draw_sum_kernel(const int32_t* __restrict__ keys, int n, uint32_t base,
                                         float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Key k = load_key(keys, lane);
  float sum = uniform(k, base);
#pragma unroll
  for (int j = 1; j < COUNT; ++j) sum += uniform(k, base + (uint32_t)j);
  out[lane] = sum;
}

template <int DEPTH>
__global__ void threefry_fold_kernel(const int32_t* __restrict__ keys, int n, uint32_t data,
                                     int32_t* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Key k = load_key(keys, lane);
#pragma unroll
  for (int i = 0; i < DEPTH; ++i) k = fold(k, data);
  out[2 * lane] = (int32_t)k.k0;
  out[2 * lane + 1] = (int32_t)k.k1;
}

}  // namespace de

extern "C" int de_threefry_uniform(const int32_t* keys, int n, unsigned data,
                                   int count, float* out, void* stream) {
  const int block = 128;
  de::threefry_uniform_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      keys, n, data, count, out);
  return (int)cudaGetLastError();
}

extern "C" int de_threefry_draws(const int32_t* keys, int n, unsigned base, int count,
                                 float* out, void* stream) {
  const int block = 128;
  de::threefry_draws_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      keys, n, base, count, out);
  return (int)cudaGetLastError();
}

extern "C" int de_threefry_draw_sum(const int32_t* keys, int n, unsigned base, int count,
                                    float* out, void* stream) {
  const int block = 128;
  const dim3 grid((n + block - 1) / block);
  if (count == 1) {
    de::threefry_draw_sum_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(keys, n, base, out);
  } else if (count == 2) {
    de::threefry_draw_sum_kernel<2><<<grid, block, 0, (cudaStream_t)stream>>>(keys, n, base, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int de_threefry_fold(const int32_t* keys, int n, unsigned data, int depth,
                                int32_t* out, void* stream) {
  const int block = 128;
  const dim3 grid((n + block - 1) / block);
  if (depth == 1) {
    de::threefry_fold_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(keys, n, data, out);
  } else if (depth == 2) {
    de::threefry_fold_kernel<2><<<grid, block, 0, (cudaStream_t)stream>>>(keys, n, data, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
