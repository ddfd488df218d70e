// naive_march: the reference's plain sphere march, one thread per lane.
//
// Replaces the TPU loop digital_earth_tpu/render/tracking_naive.py:31
// intersect_land_naive; the per-lane loop is naive_march_lane (naive.cuh),
// which the bounce entries' options instances call under naive_tracking,
// naive_march and naive_shadow. This kernel launches it on its own for the
// bounce's plain twin on the card and for the comparison with
// render/tracking_naive.intersect_land_naive_plain.
//
// What bounds it on the H100: latency and divergence (naive.cuh): a step is
// one dependent 4-byte texture read and a few dozen operations, a lane takes
// up to land_march_steps of them, and a warp runs at its longest lane.
#include <cstdint>

#include <cuda_runtime.h>

#include "naive.cuh"

namespace de {

__global__ void naive_march_kernel(const uint8_t* __restrict__ topo, int H, int W,
                                   const float* __restrict__ pos, const float* __restrict__ dir,
                                   const uint8_t* __restrict__ active, float* __restrict__ out,
                                   int32_t* __restrict__ iters, int n, float scale, int steps,
                                   int enable, int bilinear) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int it = 0;
  out[lane] = enable ? naive_march_lane(topo, H, W, scale, steps, bilinear != 0, load3(pos, lane),
                                        load3(dir, lane), active[lane] != 0, &it)
                     : -1.0f;
  if (iters) iters[lane] = it;
}

}  // namespace de

// topo (H, W, 4) uint8; pos, dir (n, 3); active (n,) bool; out (n,) hit
// distance or -1; iters null or (n,) int32 steps; enable 0: no land (every
// ray misses, no steps); bilinear: the taps' filter.
extern "C" int de_naive_march(const uint8_t* topo, int H, int W, const float* pos,
                              const float* dir, const uint8_t* active, float* out, int32_t* iters,
                              int n, float scale, int steps, int enable, int bilinear,
                              void* stream) {
  const int block = 128;
  de::naive_march_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      topo, H, W, pos, dir, active, out, iters, n, scale, steps, enable, bilinear);
  return (int)cudaGetLastError();
}
