// flight_analytic: the gases' free flight by inverting their optical depth
// on the density table (TraceConfig.analytic_flight), one thread per lane.
//
// Replaces the TPU loop digital_earth_tpu/models/atmosphere_lut.py:357, the
// fori_loop of sample_flight_distance (:302-359), with its caller
// digital_earth_tpu/render/pathtracer.py:749 _sample_rmo_flight_analytic;
// the per-lane work is flight_analytic_lane (flight_analytic.cuh), which the
// bounce entries' options instances call in place of the delta tracker.
// This kernel launches it on its own for the comparison with the plain
// twin (render/tracers.sample_rmo_flight_analytic_plain).
//
// What bounds it on the H100: the steps' dependent chain (two table rows
// from L2 a step, then the densities); no lane's count depends on its
// draws beyond collide or not, so the loop does not diverge within the
// colliding lanes.
#include <cstdint>

#include <cuda_runtime.h>

#include "flight_analytic.cuh"

namespace de {

__global__ void flight_analytic_kernel(
    const int32_t* __restrict__ keys, const float* __restrict__ pos,
    const float* __restrict__ dir, const float* __restrict__ t_start,
    const float* __restrict__ t_max, const float* __restrict__ ext_h,
    const uint8_t* __restrict__ active, const float* __restrict__ table,
    int32_t* __restrict__ event_out, float* __restrict__ t_out, int32_t* __restrict__ iid_out,
    int32_t* __restrict__ iters, int n, int n_iter) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int event, iid;
  float t;
  flight_analytic_lane(table, load_key(keys, lane), load3(pos, lane), load3(dir, lane),
                       t_start[lane], t_max[lane], ext_h[3 * lane], ext_h[3 * lane + 1],
                       ext_h[3 * lane + 2], active[lane] != 0, n_iter, event, t, iid,
                       iters ? iters + lane : nullptr);
  event_out[lane] = event;
  t_out[lane] = t;
  iid_out[lane] = iid;
}

}  // namespace de

// keys (n, 2) int32; pos, dir (n, 3); t_start, t_max (n,); ext_h (n, 3)
// float32; active (n,) bool; table (384, 1024, 3) float32; event, iid (n,)
// int32, t (n,) float32 out; iters (n,) int32 out (the steps of each lane)
// or null.
extern "C" int de_flight_analytic(const int32_t* keys, const float* pos, const float* dir,
                                  const float* t_start, const float* t_max, const float* ext_h,
                                  const uint8_t* active, const float* table, int32_t* event,
                                  float* t, int32_t* iid, int32_t* iters, int n, int n_iter,
                                  void* stream) {
  if (n_iter < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int block = 128;
  de::flight_analytic_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      keys, pos, dir, t_start, t_max, ext_h, active, table, event, t, iid, iters, n, n_iter);
  return (int)cudaGetLastError();
}
