// land_march: the displaced-sphere land march with the reference's phantom
// crawl, one thread per lane.
//
// Replaces the TPU loop digital_earth_tpu/render/pathtracer.py:211
// intersect_land and :515 _phantom_crawl; the per-lane loop is
// land_march_lane (land_march.cuh), which the bounce kernel calls too. This
// kernel launches it on its own for the preview and for the comparison with
// the plain twin.
//
// What bounds it on the H100: latency and divergence, not bandwidth. Each
// probe is one dependent 4-byte texture read and a few dozen flops, and a
// warp runs until its slowest lane has finished (budget 250 probes, most
// lanes stop within ~8). This first version keeps the loop simple; lane
// regrouping by expected trip count and texture-cache reads are later work.
#include <cstdint>

#include <cuda_runtime.h>

#include "land_march.cuh"

namespace de {

__global__ void land_march_kernel(const uint8_t* __restrict__ topo,
                                  const float* __restrict__ pos,
                                  const float* __restrict__ dir,
                                  const uint8_t* __restrict__ active,
                                  const float* __restrict__ t_cap,
                                  float* __restrict__ out, int n, MarchParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  out[lane] = land_march_lane(topo, p, load3(pos, lane), load3(dir, lane), active[lane] != 0,
                              t_cap[lane]);
}

}  // namespace de

extern "C" int de_land_march(const uint8_t* topo, int H, int W, const float* pos,
                             const float* dir, const uint8_t* active,
                             const float* t_cap, float* out, int n, float scale,
                             float step_floor, float stall_thresh, int steps,
                             int k, int patience, int any_hit, void* stream) {
  const de::MarchParams p{H, W, scale, step_floor, stall_thresh, steps, k,
                          patience, any_hit};
  const int block = 128;
  de::land_march_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      topo, pos, dir, active, t_cap, out, n, p);
  return (int)cudaGetLastError();
}
