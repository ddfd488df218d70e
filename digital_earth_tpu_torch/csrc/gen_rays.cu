// gen_rays: ray generation and wavelength sampling, one thread per lane.
//
// Replaces digital_earth_tpu/render/renderer.py:160 gen_rays (inside
// _trace_tile_range) with render/camera.py:37 cast_dirs and
// ops/spectral.py:42 spectrum_sample / :88 spectrum_sample_hero, the first
// stage of both the path-traced and the preview frame. Per lane:
//   - the pixel of the lane from the tile map (tile-major lanes of
//     (bw, bh) blocks; the path frame passes blocks of (1, H), which is
//     pixel order), pid = pu * H + pv; with a tile list (an adaptive pass,
//     renderer.py:304 _trace_tile_range(..., tile_ids=)), lane l lies in
//     tile tile_ids[l / (bw * bh)];
//   - the lane key fold(spp_key, pid);
//   - the R3 rQMC point (host-computed, uint32 fixed point rounded to
//     float32) plus the Cranley-Patterson shift
//     uniform(fold(fold(pixel_domain_key, pid), 101), 0..2), mod 1;
//   - the jittered pinhole direction from the camera basis (computed once
//     on the host);
//   - the CIE inverse CDF: binary search for the first g[i] >= u
//     (searchsorted side="left"), clipped to [1, res - 1], then the hero
//     packet's L rotations (L = 4) or the preview's single wavelength
//     (L = 1, with 1 / pdf).
//
// What bounds it on the H100: integer work (three threefry2x32 blocks of
// 20 rounds for the keys and the shift) and a 9-step search in a 441-entry
// table that stays in L1; it writes about 100 bytes per lane. One launch
// per frame or chunk replaces some 700 element-wise PyTorch launches.
#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace de {

constexpr uint32_t SITE_JITTER = 101u;

struct RayGenParams {
  float d[3], du[3], dv[3];
  float two_fov, fov, fov_aspect, aspect_scale;
  float seq[3];
  float cdf_max[3];
  uint32_t spp_k0, spp_k1, pix_k0, pix_k1;
  int64_t lane0;
  int w, h, bw, bh, res, n_lambdas, preview;
};

__device__ __forceinline__ float saturate_f(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__global__ void gen_rays_kernel(const float* __restrict__ g,
                                const float* __restrict__ cie_response,
                                int64_t* __restrict__ keys, float* __restrict__ dirs,
                                float* __restrict__ wavelengths,
                                float* __restrict__ responses, float* __restrict__ pdf,
                                const int32_t* __restrict__ tile_ids, int n, RayGenParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t lane = p.lane0 + i;
  const int64_t tile = (int64_t)p.bw * p.bh;
  const int64_t nby = p.h / p.bh;
  const int64_t li = lane % tile;
  const int64_t tidx = tile_ids ? (int64_t)tile_ids[lane / tile] : lane / tile;
  const int64_t bx = tidx / nby, by = tidx % nby;
  const int64_t pu = bx * p.bw + li / p.bh;
  const int64_t pv = by * p.bh + li % p.bh;
  const uint32_t pid = (uint32_t)(pu * p.h + pv);

  const Key lk = fold(Key{p.spp_k0, p.spp_k1}, pid);
  keys[2 * i] = (int64_t)lk.k0;
  keys[2 * i + 1] = (int64_t)lk.k1;

  const Key sk = fold(fold(Key{p.pix_k0, p.pix_k1}, pid), SITE_JITTER);
  float u3[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float x = uniform(sk, (uint32_t)j) + p.seq[j];
    u3[j] = x - floorf(x);  // mod 1 of a value in [0, 2): exact
  }

  // cast_dirs
  const float hf = (float)p.h;
  const float fu = ((p.two_fov * ((float)pu + u3[0])) / hf - p.fov_aspect - 1e-5f) * p.aspect_scale;
  const float fv = (p.two_fov * ((float)pv + u3[1])) / hf - p.fov - 1e-5f;
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = p.d[c] + fu * p.du[c] + fv * p.dv[c];
  const float len = fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), 1e-20f);
#pragma unroll
  for (int c = 0; c < 3; ++c) dirs[3 * i + c] = v[c] / len;

  // CIE inverse CDF (searchsorted side="left")
  const float u = u3[2];
  int lo = 0, hi = p.res;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (g[mid] < u) lo = mid + 1; else hi = mid;
  }
  const int idx = min(max(lo, 1), p.res - 1);
  const float g0 = g[idx - 1], g1 = g[idx];
  const float frac = g1 > g0 ? (u - g0) / fmaxf(g1 - g0, 1e-12f) : 0.5f;
  const float mid = ((float)(idx - 1) + 0.5f + saturate_f(frac)) / (float)p.res;

  for (int l = 0; l < p.n_lambdas; ++l) {
    float m = mid + (float)l / (float)p.n_lambdas;
    m = m - floorf(m);  // mod 1 (exact for m in [0, 2))
    const int o = i * p.n_lambdas + l;
    wavelengths[o] = 390.0f + 441.0f * m;
    const float x = m * (float)p.res - 0.5f;
    const int x0 = min(max((int)floorf(x), 0), p.res - 1);
    const int x1 = min(x0 + 1, p.res - 1);
    const float t = x - (float)x0;
    float r[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[c] = cie_response[3 * x0 + c] * (1.0f - t) + cie_response[3 * x1 + c] * t;
      responses[3 * o + c] = r[c];
    }
    const float q = r[0] * p.cdf_max[0] + r[1] * p.cdf_max[1] + r[2] * p.cdf_max[2];
    const bool ok = (q > 1e-3f) && isfinite(q);
    pdf[o] = p.preview ? (ok ? 1.0f / fmaxf(q, 1e-12f) : 0.0f) : (ok ? q : 0.0f);
  }
}

}  // namespace de

// fp: d[3], du[3], dv[3], two_fov, fov, fov_aspect, aspect_scale, seq[3],
//     cdf_max[3] (19 floats)
// ip: spp_k0, spp_k1, pix_k0, pix_k1, lane0, w, h, bw, bh, res, n_lambdas,
//     preview (12 int64)
// tile_ids: int32 tile list on the device, or null for consecutive tiles
extern "C" int de_gen_rays(const float* fp, const int64_t* ip, const float* g,
                           const float* cie_response, int64_t* keys, float* dirs,
                           float* wavelengths, float* responses, float* pdf,
                           const int32_t* tile_ids, int n, void* stream) {
  de::RayGenParams p;
  for (int c = 0; c < 3; ++c) {
    p.d[c] = fp[c];
    p.du[c] = fp[3 + c];
    p.dv[c] = fp[6 + c];
    p.seq[c] = fp[13 + c];
    p.cdf_max[c] = fp[16 + c];
  }
  p.two_fov = fp[9];
  p.fov = fp[10];
  p.fov_aspect = fp[11];
  p.aspect_scale = fp[12];
  p.spp_k0 = (uint32_t)ip[0];
  p.spp_k1 = (uint32_t)ip[1];
  p.pix_k0 = (uint32_t)ip[2];
  p.pix_k1 = (uint32_t)ip[3];
  p.lane0 = ip[4];
  p.w = (int)ip[5];
  p.h = (int)ip[6];
  p.bw = (int)ip[7];
  p.bh = (int)ip[8];
  p.res = (int)ip[9];
  p.n_lambdas = (int)ip[10];
  p.preview = (int)ip[11];
  const int block = 128;
  de::gen_rays_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      g, cie_response, keys, dirs, wavelengths, responses, pdf, tile_ids, n, p);
  return (int)cudaGetLastError();
}
