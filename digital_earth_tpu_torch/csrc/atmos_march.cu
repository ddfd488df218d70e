// atmos_march: the preview's single-scatter march, one thread per lane.
//
// Replaces the loop nest of digital_earth_tpu/render/raymarcher.py:56
// _ray_march_atmos with its nested :34 _ray_march_transmittance; the
// per-lane loop is atmos_march_lane (atmos_march.cuh), which the preview
// kernel calls too. This kernel launches it on its own for the comparison
// with its plain twin (render/raymarcher.ray_march_atmos_plain) and for the
// twin of the whole preview on the card.
//
// What bounds it on the H100: arithmetic on the special-function units.
// Each lane evaluates the three density profiles 64 x 17 times (about five
// expf each) and touches memory only to load its 17 inputs and store two
// outputs, so there is nothing to tile or stage. Lanes that are not active
// return (0, 1); march_paths masks both outputs by the same mask.
#include <cstdint>

#include <cuda_runtime.h>

#include "atmos_march.cuh"

namespace de {

__global__ void atmos_march_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ dir,
                                   const float* __restrict__ t_start,
                                   const float* __restrict__ t_max,
                                   const float* __restrict__ sun_dir,
                                   const float* __restrict__ ext_rmo,
                                   const float* __restrict__ scattering,
                                   const uint8_t* __restrict__ active,
                                   float* __restrict__ in_scatter_out,
                                   float* __restrict__ trans_out, int n,
                                   PhaseConsts pc) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  if (!active[lane]) {
    in_scatter_out[lane] = 0.0f;
    trans_out[lane] = 1.0f;
    return;
  }
  const float ext[3] = {ext_rmo[3 * lane], ext_rmo[3 * lane + 1], ext_rmo[3 * lane + 2]};
  atmos_march_lane(load3(pos, lane), load3(dir, lane), t_start[lane], t_max[lane],
                   load3(sun_dir, lane), ext, scattering[2 * lane], scattering[2 * lane + 1],
                   pc, in_scatter_out[lane], trans_out[lane]);
}

}  // namespace de

extern "C" int de_atmos_march(const float* pos, const float* dir, const float* t_start,
                              const float* t_max, const float* sun_dir,
                              const float* ext_rmo, const float* scattering,
                              const uint8_t* active, float* in_scatter, float* trans,
                              int n, float rayl_k, float mie_e, float two_pi,
                              float log_term, void* stream) {
  const de::PhaseConsts pc{rayl_k, mie_e, two_pi, log_term};
  const int block = 128;
  de::atmos_march_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      pos, dir, t_start, t_max, sun_dir, ext_rmo, scattering, active, in_scatter, trans,
      n, pc);
  return (int)cudaGetLastError();
}
