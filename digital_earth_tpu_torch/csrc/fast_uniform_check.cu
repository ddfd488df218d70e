// fast_uniform_check: the counter hash of fast_rng.cuh over a batch of lane
// keys, out[j, lane] = fast_uniform(key, counter, j) for j < count (the
// port's ops/rng.fast_uniform(keys, counter, (count,))). A test launcher:
// chip_smoke.py holds it bit for bit against the twin on edge keys and
// counters; the trackers call the device function in their options
// instances (rmo_track.cuh, cloud_track.cuh).
//
// Replaces digital_earth_tpu/ops/rng.py:66-113 (_lowbias32, fast_uniform).
// What bounds it on the H100: integer issue, eleven ALU and IMAD
// instructions a word and a conversion, and the stores.
#include <cstdint>

#include <cuda_runtime.h>

#include "fast_rng.cuh"

namespace de {

__global__ void fast_uniform_kernel(const int32_t* __restrict__ keys, int n, uint32_t counter,
                                    int count, float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Key k = load_key(keys, lane);
  for (int j = 0; j < count; ++j) out[(size_t)j * n + lane] = fast_uniform(k, counter, (uint32_t)j);
}

}  // namespace de

// keys (n, 2) int32; out (count, n) float32.
extern "C" int de_fast_uniform(const int32_t* keys, int n, unsigned int counter, int count,
                               float* out, void* stream) {
  if (n <= 0 || count <= 0) return (int)cudaGetLastError();
  const int block = 128;
  de::fast_uniform_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      keys, n, counter, count, out);
  return (int)cudaGetLastError();
}
