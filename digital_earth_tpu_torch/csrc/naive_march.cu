// naive_march: the reference's plain sphere march, block-cooperative.
//
// Replaces the TPU loop digital_earth_tpu/render/tracking_naive.py:31
// intersect_land_naive. The kernel runs naive_march_block (naive.cuh), the
// same device function that the bounce entries' knob instances call at the
// shadow march under naive_march and naive_shadow (bounce_shade's BLOCK
// instances; bounce_flight's marches, the shadow march under naive_tracking
// and bounce_window run the one-thread loop, naive_march_lane); it launches
// it on its own for the bounce's plain twin on the card and for the
// comparison with render/tracking_naive.intersect_land_naive_plain. On a
// dense call, where one thread a lane already keeps most of a warp busy,
// the block's rounds cost more than they save (PERF.md, row 17); the
// launcher keeps them so that the form the bounce runs is held against the
// twin on its own.
//
// What bounds it on the H100: the issue slots of its steps. A step is one
// nearest tap (its length, three IEEE divisions, atan2f, asinf and one
// dependent 4-byte read) and the SDF, a lane's steps a dependent chain of
// up to land_march_steps, and one thread a lane a warp issues every step of
// its longest lane. The warps of a block with a marching lane go in rounds
// of steps, between which they pack their lanes still marching onto their
// first warps where that empties one (naive.cuh), so the warps they empty
// stop issuing.
//
// The measurement kernels beside it (the one-thread loop, its census and
// the SASS of a step) are in bench/naive_march_bench.cu, a library of their
// own that no path loads.
#include <cstdint>

#include <cuda_runtime.h>

#include "naive.cuh"

namespace de {

constexpr int NAIVE_MARCH_BLOCK = 128;

__global__ void __launch_bounds__(NAIVE_MARCH_BLOCK)
    naive_march_kernel(const uint8_t* __restrict__ topo, int H, int W,
                       const float* __restrict__ pos, const float* __restrict__ dir,
                       const uint8_t* __restrict__ active, float* __restrict__ out,
                       int32_t* __restrict__ iters, int n, float scale, int steps, int enable,
                       int bilinear) {
  // every thread of the block takes part; one past the lanes brings the last
  // lane, inactive
  const int i = blockIdx.x * NAIVE_MARCH_BLOCK + threadIdx.x;
  const bool in = i < n;
  const int lane = in ? i : n - 1;
  int it = 0;
  const float t = naive_march_block<NAIVE_MARCH_BLOCK>(
      topo, H, W, scale, steps, bilinear != 0, load3(pos, lane), load3(dir, lane),
      in && enable && active[lane] != 0, &it);
  if (!in) return;
  out[lane] = t;
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
  const int block = de::NAIVE_MARCH_BLOCK;
  de::naive_march_kernel<<<(n + block - 1) / block, block,
                           de::naive_march_smem<de::NAIVE_MARCH_BLOCK>(), (cudaStream_t)stream>>>(
      topo, H, W, pos, dir, active, out, iters, n, scale, steps, enable, bilinear);
  return (int)cudaGetLastError();
}
