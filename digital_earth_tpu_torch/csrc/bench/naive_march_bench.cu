// Measurement kernels of the naive march (csrc/naive_march.cu) that no
// render path launches, in a library of their own (kernels.bench_library):
// naive_march_loop, the one-thread loop (naive_march_lane, the design that
// the launcher's block rounds replaced, timed beside them) and its census
// instance; and naive_steps, K steps a thread, whose SASS at K = 2 less
// that at K = 1 chip_smoke.py counts as one step's instructions.
#include <cstdint>

#include <cuda_runtime.h>

#include "../naive.cuh"

namespace de {

// The census's clock: the SM's cycle counter, ordered with the memory
// operations around it.
__device__ __forceinline__ long long census_clock() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c)::"memory");
  return c;
}

// naive_march_lane, one thread a lane (the design before the block's, kept
// to time beside it) or, with CENSUS, its steps at nearest taps with each
// step's cycles summed per lane into cycles[4 * lane + k]: k = 0 the point,
// its length and the three divisions; 1 the angles (atan2f, asinf) and the
// texel coordinates; 2 the texel's index, its read and its channel's
// conversion; 3 the SDF, the new distance and the stop tests (sphere_tap's
// statements written out between the clock reads).
template <bool CENSUS>
__global__ void naive_march_loop_kernel(const uint8_t* __restrict__ topo, int H, int W,
                                        const float* __restrict__ pos,
                                        const float* __restrict__ dir,
                                        const uint8_t* __restrict__ active,
                                        float* __restrict__ out, int32_t* __restrict__ iters,
                                        long long* __restrict__ cycles, int n, float scale,
                                        int steps, int bilinear) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const V3 o = load3(pos, lane), d = load3(dir, lane);
  const bool act = active[lane] != 0;
  int it = 0;
  if constexpr (!CENSUS) {
    out[lane] = naive_march_lane(topo, H, W, scale, steps, bilinear != 0, o, d, act, &it);
    if (iters) iters[lane] = it;
    return;
  }
  float t = naive_march_start(o, d);
  bool done = !act;
  long long c[4] = {0, 0, 0, 0};
  for (int i = 0; i < steps && !done; ++i) {
    ++it;
    long long c0 = census_clock();
    const V3 ro = along(o, t, d);
    const float l = fmaxf(length(ro), 1e-20f);
    const float nx = ro.x / l, ny = ro.y / l, nz = ro.z / l;
    long long c1 = census_clock();
    c[0] += c1 - c0;
    const float u = (atan2f(nz, -nx) * INV_PI_F + 1.0f) * 0.5f;
    const float v = asinf(fminf(fmaxf(ny, -1.0f), 1.0f)) * INV_PI_F + 0.5f;
    const float x = u * (float)W - 0.5f;
    const float y = fminf(fmaxf((1.0f - v) * (float)H - 0.5f, 0.0f), (float)H - 1.0f);
    c0 = census_clock();
    c[1] += c0 - c1;
    int ix = (int)rintf(x) % W;
    if (ix < 0) ix += W;
    const int iy = min(max((int)rintf(y), 0), H - 1);
    const float s0 = (float)(texel4(topo, (size_t)iy * W + ix) & 0xFFu) * (1.0f / 255.0f);
    c1 = census_clock();
    c[2] += c1 - c0;
    const float dist = (length(ro) - PLANET_R_F) - scale * s0;
    const float t_new = t + dist;
    done = (t_new > MAX_RAY_DIST_F) || (fabsf(dist) < t_new * 1e-4f);
    t = t_new;
    c0 = census_clock();
    c[3] += c0 - c1;
  }
  out[lane] = act && t < MAX_RAY_DIST_F ? t : -1.0f;
  if (iters) iters[lane] = it;
#pragma unroll
  for (int k = 0; k < 4; ++k) cycles[4 * lane + k] = c[k];
}

// K dependent steps of the march a thread (nearest taps), between a lane's
// seven loads and two stores: the instances K = 2 and K = 1 differ by one
// step, the loop's statements with its stop tests.
template <int K>
__global__ void naive_steps_kernel(const uint8_t* __restrict__ topo, int H, int W,
                                   const float* __restrict__ pos, const float* __restrict__ dir,
                                   const float* __restrict__ t_in, float* __restrict__ t_out,
                                   uint8_t* __restrict__ done_out, int n, float scale) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const V3 o = load3(pos, lane), d = load3(dir, lane);
  float t = t_in[lane];
  bool done = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bool stop;
    t = naive_march_step(topo, H, W, scale, false, o, d, t, stop);
    done = done || stop;
  }
  t_out[lane] = t;
  done_out[lane] = done;
}

// No C entry launches them: chip_smoke.py reads their SASS from the library.
template __global__ void naive_steps_kernel<1>(const uint8_t*, int, int, const float*,
                                               const float*, const float*, float*, uint8_t*, int,
                                               float);
template __global__ void naive_steps_kernel<2>(const uint8_t*, int, int, const float*,
                                               const float*, const float*, float*, uint8_t*, int,
                                               float);

}  // namespace de

// The one-thread loop of de_naive_march's lanes (the arguments as there;
// enable 1): cycles null, the loop; else (n, 4) int64, the census of its
// steps (nearest taps only: bilinear must be 0).
extern "C" int de_naive_march_loop(const uint8_t* topo, int H, int W, const float* pos,
                                   const float* dir, const uint8_t* active, float* out,
                                   int32_t* iters, long long* cycles, int n, float scale,
                                   int steps, int bilinear, void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (cycles) {
    if (bilinear) return (int)cudaErrorInvalidValue;
    de::naive_march_loop_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        topo, H, W, pos, dir, active, out, iters, cycles, n, scale, steps, 0);
  } else {
    de::naive_march_loop_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        topo, H, W, pos, dir, active, out, iters, nullptr, n, scale, steps, bilinear);
  }
  return (int)cudaGetLastError();
}
