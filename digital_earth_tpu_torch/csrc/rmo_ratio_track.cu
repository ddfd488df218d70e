// rmo_ratio_track: ratio tracking of the gases' (Rayleigh / Mie / ozone)
// transmittance along a ray for the L wavelengths of each lane, one thread
// per lane.
//
// Replaces the TPU loop digital_earth_tpu/render/pathtracer.py:814
// _ratio_track_rmo (its masked while_loop at :873), which the reference runs
// for the sun transmittance when TraceConfig.analytic_transmittance is
// False. The per-lane loop is rmo_ratio_lane (rmo_track.cuh), which the
// bounce entries call at their sun transmittance; this kernel launches it on
// its own for the comparison with the plain twin.
//
// Two instances a width: the default (threefry draws) and the options
// instance (FAST: the counter hash of fast_rng.cuh, TraceConfig.
// fast_loop_rng), as the bounce entries run them; the widths 1 and 4 in
// the main library, any other in that width's library (packet_width.cuh).
//
// What bounds it on the H100: neither bytes (a lane reads 60 + 12 L B and
// writes 4 L B) nor its operations, mostly threefry's integer work (a key
// and K draws per iteration), but the lanes' unequal iteration counts: a
// warp runs until its slowest lane ends, and the chord to space at the
// packet majorant takes several iterations. The design keeps the loop in
// registers and draws no probe past the lane's end.
#include <cstdint>

#include <cuda_runtime.h>

#include "packet_width.cuh"
#include "rmo_track.cuh"

namespace de {

template <int L, bool FAST>
__global__ void rmo_ratio_track_kernel(
    const int32_t* __restrict__ keys, const float* __restrict__ pos,
    const float* __restrict__ dir, const float* __restrict__ t_start,
    const float* __restrict__ t_max, const float* __restrict__ ext_in,
    const float* __restrict__ max_ext, const uint8_t* __restrict__ active,
    float* __restrict__ trans_out, int32_t* __restrict__ iters, int n, int max_steps, int k) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float ext[L][3], trans[L];
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int c = 0; c < 3; ++c) ext[l][c] = ext_in[(lane * L + l) * 3 + c];
  rmo_ratio_lane<L, FAST>(load_key(keys, lane), load3(pos, lane), load3(dir, lane),
                          t_start[lane], t_max[lane], ext, max_ext[lane], active[lane] != 0,
                          max_steps, k, trans, iters ? iters + lane : nullptr);
#pragma unroll
  for (int l = 0; l < L; ++l) trans_out[lane * L + l] = trans[l];
}

template <int L>
int launch_rmo_ratio_track(const int32_t* keys, const float* pos, const float* dir,
                           const float* t_start, const float* t_max, const float* ext,
                           const float* max_ext, const uint8_t* active, float* trans,
                           int32_t* iters, int n, int max_steps, int k, int fast,
                           cudaStream_t stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (fast) {
    rmo_ratio_track_kernel<L, true><<<grid, block, 0, stream>>>(
        keys, pos, dir, t_start, t_max, ext, max_ext, active, trans, iters, n, max_steps, k);
  } else {
    rmo_ratio_track_kernel<L, false><<<grid, block, 0, stream>>>(
        keys, pos, dir, t_start, t_max, ext, max_ext, active, trans, iters, n, max_steps, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace de

// keys (n, 2) int32; pos, dir (n, 3); t_start, t_max, max_ext (n,); ext
// (n, L, 3) float32; active (n,) bool; trans (n, L) float32 out; iters
// (n,) int32 out (the loop's iterations per lane) or null. L is a width the
// library holds (packet_width.cuh).
// fast: the options instance (the counter hash's draws).
extern "C" int de_rmo_ratio_track(const int32_t* keys, const float* pos, const float* dir,
                                  const float* t_start, const float* t_max, const float* ext,
                                  const float* max_ext, const uint8_t* active, float* trans,
                                  int32_t* iters, int n, int n_lambdas, int max_steps, int k,
                                  int fast, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  return de::with_width(n_lambdas, [&](auto width) {
    return de::launch_rmo_ratio_track<decltype(width)::value>(
        keys, pos, dir, t_start, t_max, ext, max_ext, active, trans, iters, n, max_steps, k, fast,
        s);
  });
}
