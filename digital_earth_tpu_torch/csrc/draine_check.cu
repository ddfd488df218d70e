// draine_check: a test launcher (not a path kernel) of the bounce's Draine
// sampler (volume.cuh sample_draine_cos), writing its intermediates per
// draw, and of a float64 cube root beside its float32 powf, so that
// chip_smoke.py can find the first operation at which kernel and plain twin
// (models/volume.sample_draine_cos on the card) part.
#include <cuda_runtime.h>

#include "volume.cuh"

namespace de {

__global__ void draine_check_kernel(const float* __restrict__ u, float* __restrict__ trace,
                                    float* __restrict__ cbrt_f64, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sample_draine_cos(u[i], trace + 9 * i);
  cbrt_f64[i] = (float)pow((double)trace[9 * i + 2], (double)PY(1.0 / 3.0));
}

}  // namespace de

// u (n,) float32 -> trace (n, 9): t3, t4a, t4, t4p3 (powf(t4, 1/3)), t6, t5,
// inner, s, cos before its clamp; cbrt_f64 (n,): float(pow(double(t4),
// double(float(1/3)))).
extern "C" int de_draine_check(const float* u, float* trace, float* cbrt_f64, int n,
                               void* stream) {
  if (n > 0) {
    de::draine_check_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(u, trace,
                                                                                cbrt_f64, n);
  }
  return (int)cudaGetLastError();
}
