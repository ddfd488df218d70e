// land_march: the displaced-sphere land march with the reference's phantom
// crawl, a thread per lane, the warp marching its active lanes together.
//
// Replaces the TPU loop digital_earth_tpu/render/pathtracer.py:211
// intersect_land and :515 _phantom_crawl; the march is land_march_warp
// (land_march.cuh), which the bounce entries call too. This kernel launches
// it on its own for the plain twins on the card (march_paths_plain) and for
// the comparison with intersect_land_plain.
//
// What bounds it on the H100: latency and divergence, not bandwidth. Each
// probe is one dependent 4-byte texture read and a few dozen flops, and a
// lane's iterations are a dependent chain (budget 250 probes, most lanes
// stop within ~8). So the K probes of an iteration run on K threads at
// once, and a warp's idle threads take the probes of its marching lanes.
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
  if ((lane & ~31) >= n) return;  // the whole warp lies past n
  // every other thread calls the march: it needs the full warp
  const bool in = lane < n;
  const int l = in ? lane : 0;
  const float t = land_march_warp(topo, p, load3(pos, l), load3(dir, l),
                                  in && active[l] != 0, t_cap[l]);
  if (in) out[lane] = t;
}

}  // namespace de

extern "C" int de_land_march(const uint8_t* topo, int H, int W, const float* pos,
                             const float* dir, const uint8_t* active,
                             const float* t_cap, float* out, int n, float scale,
                             float step_floor, float stall_thresh, int steps,
                             int k, int patience, int any_hit, void* stream) {
  const de::MarchParams p{H, W, scale, step_floor, stall_thresh, steps, k,
                          patience, any_hit};
  if (k < 1 || 32 % k != 0) return (int)cudaErrorInvalidValue;  // K threads to a lane
  const int block = 128;
  de::land_march_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      topo, pos, dir, active, t_cap, out, n, p);
  return (int)cudaGetLastError();
}
