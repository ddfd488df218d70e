// rmo_delta_track: Woodcock (delta) tracking of a free-flight event through
// the Rayleigh / Mie / ozone gases, one thread per lane.
//
// Replaces the TPU loop digital_earth_tpu/render/pathtracer.py:631
// _delta_track_rmo; the per-lane loop is rmo_track_lane (rmo_track.cuh),
// which the bounce kernel calls too. This kernel launches it on its own for
// the comparison with the plain twin.
//
// Two instances: the default (threefry draws) and the options instance
// (FAST: the counter hash of fast_rng.cuh, TraceConfig.fast_loop_rng), as
// the bounce entries run them.
//
// What bounds it on the H100: latency and divergence. No memory is read in
// the loop (the densities are analytic); each iteration is ~13 threefry
// blocks plus K exp/log evaluations, and a warp runs until its slowest lane
// stops, so the cost is the worst lane's iteration count per warp.
#include <cstdint>

#include <cuda_runtime.h>

#include "rmo_track.cuh"

namespace de {

template <bool FAST>
__global__ void rmo_delta_track_kernel(
    const int32_t* __restrict__ keys, const float* __restrict__ pos,
    const float* __restrict__ dir, const float* __restrict__ t_start,
    const float* __restrict__ t_max, const float* __restrict__ ext_h,
    const uint8_t* __restrict__ active, int32_t* __restrict__ event_out,
    float* __restrict__ t_out, int32_t* __restrict__ iid_out, int n,
    int max_steps, int k, float o3_env_peak) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int event, iid;
  float t;
  rmo_track_lane<FAST>(load_key(keys, lane), load3(pos, lane), load3(dir, lane), t_start[lane],
                       t_max[lane], ext_h[3 * lane], ext_h[3 * lane + 1], ext_h[3 * lane + 2],
                       active[lane] != 0, max_steps, k, o3_env_peak, event, t, iid);
  event_out[lane] = event;
  t_out[lane] = t;
  iid_out[lane] = iid;
}

}  // namespace de

// fast: the options instance (the counter hash's draws).
extern "C" int de_rmo_delta_track(const int32_t* keys, const float* pos,
                                  const float* dir, const float* t_start,
                                  const float* t_max, const float* ext_h,
                                  const uint8_t* active, int32_t* event,
                                  float* t, int32_t* iid, int n, int max_steps,
                                  int k, float o3_env_peak, int fast, void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (fast) {
    de::rmo_delta_track_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        keys, pos, dir, t_start, t_max, ext_h, active, event, t, iid, n, max_steps, k,
        o3_env_peak);
  } else {
    de::rmo_delta_track_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        keys, pos, dir, t_start, t_max, ext_h, active, event, t, iid, n, max_steps, k,
        o3_env_peak);
  }
  return (int)cudaGetLastError();
}
