// cloud_track: space-skipping tracking of the cloud slab, one thread per
// lane, in delta mode (first real collision: event and distance) or ratio
// mode (transmittance with Russian roulette).
//
// Replaces the TPU loop digital_earth_tpu/render/pathtracer.py:906
// _track_cloud; the per-lane loop is cloud_track_lane (cloud_track.cuh),
// which the bounce kernel calls too. This kernel launches it on its own for
// the comparison with the plain twin.
//
// What bounds it on the H100: latency and divergence. Each probe is one
// dependent 32-bit texture read plus an atan2/asin pair; a warp runs until
// its slowest lane leaves the slab (up to 8192 iterations for grazing sun
// chords), so the cost is per-warp worst-lane trip count, not bandwidth.
//
// Three instances: the default (nearest taps, threefry draws), the options
// instance (OPTS: bilinear taps where asked) and its counter-hash twin
// (FAST: the draws of fast_rng.cuh, TraceConfig.fast_loop_rng), as the
// bounce entries run them.
#include <cstdint>

#include <cuda_runtime.h>

#include "cloud_track.cuh"

namespace de {

template <bool OPTS, bool FAST>
__global__ void cloud_track_kernel(
    const int32_t* __restrict__ keys, const float* __restrict__ pos,
    const float* __restrict__ dir, const float* __restrict__ t_start,
    const float* __restrict__ t_max, const float* __restrict__ ext_w,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ clouds,
    int H, int W, int32_t* __restrict__ event_out, float* __restrict__ t_out,
    float* __restrict__ trans_out, int n, int max_steps, int k, int ratio, int bilinear) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int event;
  float t, trans;
  cloud_track_lane<OPTS, FAST>(load_key(keys, lane), load3(pos, lane), load3(dir, lane),
                               t_start[lane], t_max[lane], ext_w[lane], active[lane] != 0, clouds,
                               H, W, max_steps, k, ratio != 0, event, t, trans, nullptr,
                               bilinear != 0);
  event_out[lane] = event;
  t_out[lane] = t;
  trans_out[lane] = trans;
}

}  // namespace de

extern "C" int de_cloud_track(const int32_t* keys, const float* pos,
                              const float* dir, const float* t_start,
                              const float* t_max, const float* ext_w,
                              const uint8_t* active, const uint8_t* clouds,
                              int H, int W, int32_t* event, float* t,
                              float* trans, int n, int max_steps, int k,
                              int ratio, int opts, int bilinear, int fast, void* stream) {
  // the default runs nearest taps and threefry draws
  if (!opts && (bilinear || fast)) return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  if (opts && fast) {
    de::cloud_track_kernel<true, true><<<grid, block, 0, st>>>(
        keys, pos, dir, t_start, t_max, ext_w, active, clouds, H, W, event, t, trans, n,
        max_steps, k, ratio, bilinear);
  } else if (opts) {
    de::cloud_track_kernel<true, false><<<grid, block, 0, st>>>(
        keys, pos, dir, t_start, t_max, ext_w, active, clouds, H, W, event, t, trans, n,
        max_steps, k, ratio, bilinear);
  } else {
    de::cloud_track_kernel<false, false><<<grid, block, 0, st>>>(
        keys, pos, dir, t_start, t_max, ext_w, active, clouds, H, W, event, t, trans, n,
        max_steps, k, ratio, bilinear);
  }
  return (int)cudaGetLastError();
}
