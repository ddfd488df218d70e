// Test-only launcher for density_lut.cuh: per lane, the density integrals
// over [t0, t1] (density_integral_segment) and the RMO transmittance to
// space for 4 wavelengths (rmo_transmittance_to_space), the functions the
// bounce kernel calls. chip_smoke.py and the card tests hold it against the
// plain versions in models/atmosphere_lut.py; it is not on the render path.
#include <cstdint>

#include <cuda_runtime.h>

#include "density_lut.cuh"

namespace de {

constexpr int CHECK_L = 4;

__global__ void density_check_kernel(const float* __restrict__ pos,
                                     const float* __restrict__ dir,
                                     const float* __restrict__ t0,
                                     const float* __restrict__ t1,
                                     const float* __restrict__ ext_rmo,
                                     const float* __restrict__ table,
                                     float* __restrict__ seg, float* __restrict__ trans, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = load3(pos, i), d = load3(dir, i);
  float s[3];
  density_integral_segment(table, o, d, t0[i], t1[i], s);
#pragma unroll
  for (int c = 0; c < 3; ++c) seg[3 * i + c] = s[c];
  float ext[CHECK_L][3], tr[CHECK_L];
#pragma unroll
  for (int l = 0; l < CHECK_L; ++l)
#pragma unroll
    for (int c = 0; c < 3; ++c) ext[l][c] = ext_rmo[(i * CHECK_L + l) * 3 + c];
  rmo_transmittance_to_space<CHECK_L>(table, ext, o, d, tr);
#pragma unroll
  for (int l = 0; l < CHECK_L; ++l) trans[i * CHECK_L + l] = tr[l];
}

}  // namespace de

// pos, dir (n, 3); t0, t1 (n,); ext_rmo (n, 4, 3); table (384, 1024, 3)
// -> seg (n, 3), trans (n, 4).
extern "C" int de_density_check(const float* pos, const float* dir, const float* t0,
                                const float* t1, const float* ext_rmo, const float* table,
                                float* seg, float* trans, int n, int n_lambdas, void* stream) {
  if (n_lambdas != de::CHECK_L) return (int)cudaErrorInvalidValue;
  const int block = 128;
  if (n > 0) {
    de::density_check_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        pos, dir, t0, t1, ext_rmo, table, seg, trans, n);
  }
  return (int)cudaGetLastError();
}
