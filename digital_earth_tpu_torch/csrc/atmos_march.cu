// atmos_march: the preview's single-scatter march over n lanes, a test
// launcher of the device function the preview kernel runs.
//
// Replaces the loop nest of digital_earth_tpu/render/raymarcher.py:56
// _ray_march_atmos with its nested :34 _ray_march_transmittance; the march
// is atmos_march_warp (atmos_march.cuh), warp-cooperative, which the preview
// kernel calls too. This kernel launches it on its own for the comparison
// with its plain twin (render/raymarcher.ray_march_atmos_plain), for the
// twin of the whole preview on the card, and to time the march apart from
// the rest of the preview.
//
// What bounds it on the H100: instruction issue (FP32 and SFU) and divergence.
// Each active lane evaluates the three density profiles 64 x 17 times (four
// expf and a sqrtf each) and touches memory only to load its
// 17 inputs and store two outputs, so there is nothing to tile or stage. A
// warp runs only its active lanes' marches, 16 threads to a lane, instead of
// its slowest lane's whole march on every thread. Lanes that are not active
// get (0, 1); march_paths masks both outputs by the same mask.
#include <cstdint>

#include <cuda_runtime.h>

#include "atmos_march.cuh"

namespace de {

constexpr int ATMOS_BLOCK = 128;

__global__ void __launch_bounds__(ATMOS_BLOCK)
    atmos_march_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                       const float* __restrict__ t_start, const float* __restrict__ t_max,
                       const float* __restrict__ sun_dir, const float* __restrict__ ext_rmo,
                       const float* __restrict__ scattering, const uint8_t* __restrict__ active,
                       float* __restrict__ in_scatter_out, float* __restrict__ trans_out, int n,
                       PhaseConsts pc) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~31) >= n) return;  // the whole warp lies past n
  const bool in = lane < n;
  const bool act = in && active[lane];
  const int l = in ? lane : 0;
  const float ext[3] = {ext_rmo[3 * l], ext_rmo[3 * l + 1], ext_rmo[3 * l + 2]};
  float in_scatter = 0.0f, trans = 1.0f;
  atmos_march_warp(act, load3(pos, l), load3(dir, l), t_start[l], t_max[l], load3(sun_dir, l),
                   ext, scattering[2 * l], scattering[2 * l + 1], pc, in_scatter, trans);
  if (in) {
    in_scatter_out[lane] = in_scatter;
    trans_out[lane] = trans;
  }
}

}  // namespace de

extern "C" int de_atmos_march(const float* pos, const float* dir, const float* t_start,
                              const float* t_max, const float* sun_dir,
                              const float* ext_rmo, const float* scattering,
                              const uint8_t* active, float* in_scatter, float* trans,
                              int n, float rayl_k, float mie_e, float two_pi,
                              float log_term, void* stream) {
  const de::PhaseConsts pc{rayl_k, mie_e, two_pi, log_term};
  if (n <= 0) return 0;
  const int blocks = (n + de::ATMOS_BLOCK - 1) / de::ATMOS_BLOCK;
  de::atmos_march_kernel<<<blocks, de::ATMOS_BLOCK, 0, (cudaStream_t)stream>>>(
      pos, dir, t_start, t_max, sun_dir, ext_rmo, scattering, active, in_scatter, trans, n, pc);
  return (int)cudaGetLastError();
}

// Occupancy of the march: out = (resident blocks per SM, threads per block,
// registers per thread, local memory bytes per thread).
extern "C" int de_atmos_march_occupancy(int* out) {
  const void* fn = (const void*)de::atmos_march_kernel;
  int blocks = 0;
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, de::ATMOS_BLOCK, 0);
  if (rc != cudaSuccess) return (int)rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = blocks;
  out[1] = de::ATMOS_BLOCK;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
