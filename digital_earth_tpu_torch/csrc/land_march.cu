// land_march: the displaced-sphere land march with the reference's phantom
// crawl, a thread per lane, the warp marching its active lanes together.
//
// Replaces the TPU loop digital_earth_tpu/render/pathtracer.py:211
// intersect_land and :515 _phantom_crawl; the march is land_march_warp
// (land_march.cuh), which the bounce entries call too. This kernel launches
// it on its own for the plain twins on the card (march_paths_plain) and for
// the comparison with intersect_land_plain.
//
// What bounds it on the H100: latency and divergence, not bandwidth. Each
// probe is one dependent 4-byte texture read and a few dozen flops, and a
// lane's iterations are a dependent chain (budget 250 probes, most lanes
// stop within ~8). So the K probes of an iteration run on K threads at
// once, and a warp's idle threads take the probes of its marching lanes.
//
// Three instances: the default (the march's options at their defaults,
// compiled in), the options instance (OPTS: MarchOpts read at run time), the
// one the bounce entries' and the preview's options instances run, and the
// floor instance (OPTS and CERT: the options and the certified floor), the
// march of the bounce entries' estimator instances and of the preview's floor
// instance at TraceConfig.march_certified_floor.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "land_march.cuh"

namespace de {

// The options instance's parameters: the march's, then its options (the
// default instance's keep their size, and so its code); the floor
// instance's, then the uncertified floor.
struct MarchParamsOpts : MarchParams {
  MarchOpts mo;
};
struct MarchParamsCert : MarchParamsOpts {
  float uncert;
};
template <bool OPTS, bool CERT>
using LauncherParams = std::conditional_t<
    CERT, MarchParamsCert, std::conditional_t<OPTS, MarchParamsOpts, MarchParams>>;

template <bool OPTS, bool CERT = false>
__global__ void land_march_kernel(const uint8_t* __restrict__ topo,
                                  const float* __restrict__ pos,
                                  const float* __restrict__ dir,
                                  const uint8_t* __restrict__ active,
                                  const float* __restrict__ t_cap,
                                  float* __restrict__ out, int n, LauncherParams<OPTS, CERT> p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~31) >= n) return;  // the whole warp lies past n
  // every other thread calls the march: it needs the full warp
  const bool in = lane < n;
  const int l = in ? lane : 0;
  float t;
  if constexpr (CERT) {
    t = land_march_warp<true, true>(topo, p, load3(pos, l), load3(dir, l), in && active[l] != 0,
                                    t_cap[l], nullptr, &p.mo, p.uncert);
  } else if constexpr (OPTS) {
    t = land_march_warp<true>(topo, p, load3(pos, l), load3(dir, l), in && active[l] != 0,
                              t_cap[l], nullptr, &p.mo);
  } else {
    t = land_march_warp(topo, p, load3(pos, l), load3(dir, l), in && active[l] != 0, t_cap[l]);
  }
  if (in) out[lane] = t;
}

}  // namespace de

extern "C" int de_land_march(const uint8_t* topo, int H, int W, const float* pos,
                             const float* dir, const uint8_t* active,
                             const float* t_cap, float* out, int n, float scale,
                             float step_floor, float stall_thresh, int steps,
                             int k, int patience, int any_hit, int opts, int enable,
                             int bilinear, int exact_ocean, int ref_phantom, int cert,
                             float uncert, void* stream) {
  const de::MarchParams p{H, W, scale, step_floor, stall_thresh, steps, k,
                          patience, any_hit};
  if (k < 1 || 32 % k != 0) return (int)cudaErrorInvalidValue;  // K threads to a lane
  // the default instance runs the defaults only
  if (!opts && !(enable == 1 && bilinear == 0 && exact_ocean == 1 && ref_phantom == 1))
    return (int)cudaErrorInvalidValue;
  // the floor instance takes the options too, and a floor above 0
  if (cert && !(opts && uncert > 0.0f)) return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (cert) {
    de::MarchParamsCert pc;
    static_cast<de::MarchParams&>(pc) = p;
    pc.mo = de::MarchOpts{enable, bilinear, exact_ocean, ref_phantom};
    pc.uncert = uncert;
    de::land_march_kernel<true, true><<<grid, block, 0, (cudaStream_t)stream>>>(
        topo, pos, dir, active, t_cap, out, n, pc);
  } else if (opts) {
    de::MarchParamsOpts po;
    static_cast<de::MarchParams&>(po) = p;
    po.mo = de::MarchOpts{enable, bilinear, exact_ocean, ref_phantom};
    de::land_march_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(topo, pos, dir, active,
                                                                         t_cap, out, n, po);
  } else {
    de::land_march_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(topo, pos, dir, active,
                                                                          t_cap, out, n, p);
  }
  return (int)cudaGetLastError();
}
