// Test-only launcher for threefry.cuh: out[j, lane] = uniform(fold(key, data), j),
// the same numbers as ops/rng.uniform(ops/rng.fold(keys, data), (count,)).
// chip_smoke.py holds it bit for bit against the plain version; it is not on
// the render path.
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

}  // namespace de

extern "C" int de_threefry_uniform(const int32_t* keys, int n, unsigned data,
                                   int count, float* out, void* stream) {
  const int block = 128;
  de::threefry_uniform_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      keys, n, data, count, out);
  return (int)cudaGetLastError();
}
