// naive_track: the reference's one-step trackers at the global majorant:
// delta tracking (naive_delta_track) of the gases or of the cloud slab, and
// ratio tracking (naive_ratio_track) of either.
//
// Replaces the TPU loops digital_earth_tpu/render/tracking_naive.py:72
// delta_track_naive and :126 ratio_track_naive. Delta tracking and the
// cloud's ratio tracking run as warp-cooperative steps (naive.cuh
// naive_track_warp), the gases' ratio tracking as rmo_ratio_lane at one
// wavelength and one probe an iteration (rmo_track.cuh), one thread a lane:
// the loops the bounce entries' options instances run under naive_tracking
// and naive_cloud_tracking. This kernel launches them on their own for the
// bounce's plain twin on the card and for the comparison with
// render/tracking_naive's plain versions.
//
// What bounds it on the H100: latency and divergence (naive.cuh): a step is
// one or three threefry draws, a density (analytic, or one dependent texture
// read for the cloud) and a few dozen operations, a lane takes up to
// max_steps of them, and one thread a lane a warp runs at its longest lane;
// the warp-cooperative steps give its idle threads the steps of the lanes
// still tracking.
#include <cstdint>

#include <cuda_runtime.h>

#include "naive.cuh"
#include "rmo_track.cuh"

namespace de {

template <int SPECIES, bool RATIO>
__global__ void naive_track_kernel(const int32_t* __restrict__ keys, const float* __restrict__ pos,
                                   const float* __restrict__ dir,
                                   const float* __restrict__ t_start,
                                   const float* __restrict__ t_max, const float* __restrict__ ext,
                                   const float* __restrict__ max_ext,
                                   const uint8_t* __restrict__ active,
                                   const uint8_t* __restrict__ clouds, int H, int W,
                                   int32_t* __restrict__ event_out, float* __restrict__ t_out,
                                   int32_t* __restrict__ iid_out, float* __restrict__ trans_out,
                                   int32_t* __restrict__ iters, int n, int max_steps,
                                   int bilinear) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  // a warp wholly past the lanes leaves; the others stay whole, as
  // naive_track_warp needs, a thread past the lanes reading the last lane
  // and writing nothing
  if ((idx & ~31) >= n) return;
  const bool in = idx < n;
  const int lane = in ? idx : n - 1;
  const float* e = ext + 4 * lane;
  // the gases' three extinctions, or the cloud's (channel 3)
  const float e0 = SPECIES == NAIVE_RMO ? e[0] : e[3];
  const float e1 = SPECIES == NAIVE_RMO ? e[1] : 0.0f;
  const float e2 = SPECIES == NAIVE_RMO ? e[2] : 0.0f;
  int it = 0;
  if constexpr (RATIO && SPECIES == NAIVE_RMO) {
    if (!in) return;
    const float ext1[1][3] = {{e0, e1, e2}};
    float trans[1];
    rmo_ratio_lane<1>(load_key(keys, lane), load3(pos, lane), load3(dir, lane), t_start[lane],
                      t_max[lane], ext1, max_ext[lane], active[lane] != 0, max_steps, 1, trans,
                      &it);
    trans_out[lane] = trans[0];
  } else {
    const NaiveTrack r = naive_track_warp<SPECIES, RATIO>(
        load_key(keys, lane), load3(pos, lane), load3(dir, lane), t_start[lane], t_max[lane], e0,
        e1, e2, max_ext[lane], in && active[lane] != 0, clouds, H, W, bilinear != 0, max_steps,
        &it);
    if (!in) return;
    if constexpr (RATIO) {
      trans_out[lane] = r.trans;
    } else {
      event_out[lane] = r.event;
      t_out[lane] = r.t;
      iid_out[lane] = r.iid;
    }
  }
  if (iters) iters[lane] = it;
}

}  // namespace de

// keys (n, 2) int32; pos, dir (n, 3); t_start, t_max (n,); ext (n, 4) (the
// gases' three extinctions, then the cloud's); max_ext (n,) the global
// majorant; active (n,) bool; clouds (H, W, 4) uint8 (the cloud species
// only, else null); outputs event, iid (n,) int32 and t (n,) (delta),
// trans (n,) (ratio); iters null or (n,) int32 steps; species 0 the gases,
// 1 the cloud; ratio 1 ratio tracking, 0 delta tracking.
extern "C" int de_naive_track(const int32_t* keys, const float* pos, const float* dir,
                              const float* t_start, const float* t_max, const float* ext,
                              const float* max_ext, const uint8_t* active, const uint8_t* clouds,
                              int H, int W, int32_t* event, float* t, int32_t* iid, float* trans,
                              int32_t* iters, int n, int max_steps, int species, int ratio,
                              int bilinear, void* stream) {
  if ((species != 0 && species != 1) || (ratio != 0 && ratio != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (species == 1 && clouds == nullptr) return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
#define DE_NAIVE_LAUNCH(SP, R)                                                                    \
  de::naive_track_kernel<SP, R><<<grid, block, 0, s>>>(keys, pos, dir, t_start, t_max, ext,      \
                                                       max_ext, active, clouds, H, W, event, t, \
                                                       iid, trans, iters, n, max_steps, bilinear)
  if (species == 0) {
    if (ratio) DE_NAIVE_LAUNCH(de::NAIVE_RMO, true);
    else DE_NAIVE_LAUNCH(de::NAIVE_RMO, false);
  } else {
    if (ratio) DE_NAIVE_LAUNCH(de::NAIVE_CLOUD, true);
    else DE_NAIVE_LAUNCH(de::NAIVE_CLOUD, false);
  }
#undef DE_NAIVE_LAUNCH
  return (int)cudaGetLastError();
}
