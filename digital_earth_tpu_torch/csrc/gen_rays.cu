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
//     tile tile_ids[l / (bw * bh)]. The lane's pid is an output, and for
//     the preview (keyed by tile) its tile index and in-tile lane too;
//   - the lane key fold(spp_key, pid);
//   - the R3 rQMC point (host-computed, uint32 fixed point rounded to
//     float32) plus the Cranley-Patterson shift
//     uniform(fold(fold(pixel_domain_key, pid), 101), 0..2), mod 1; or,
//     unstratified (TraceConfig.stratify_spp False, renderer.py:189-191),
//     the jitter uniform(fold(lane_key, 101), 0..1) and the wavelength's
//     uniform(fold(lane_key, 102), 0);
//   - the jittered pinhole direction from the camera basis (computed once
//     on the host);
//   - the CIE inverse CDF: binary search for the first g[i] >= u
//     (searchsorted side="left"), clipped to [1, res - 1], then the hero
//     packet's L rotations (TraceConfig.hero_lambdas: 1 or 4 in the main
//     library, any other L in that width's library, packet_width.cuh; the
//     pdf q of each) or the preview's single wavelength (L = 1, 1 / q).
// Each Python divisor of the plain twin (/ H in cast_dirs, / res in
// _cie_mid) is a multiply by float32(1 / b), the reciprocal taken in
// double, as PyTorch's CUDA ops apply it, and the rotations are l *
// float32(1 / L), as the twin (ops/spectral.hero_shifts) and the jitted
// reference take them (ROADMAP C #6); so every field agrees with the twin
// bit for bit.
//
// Design: lane arithmetic in 32 bits (the wrapper keeps lane0 + n < 2^31),
// the tile map's divisions by per-launch constants as multiply-high
// divisors; g and the XYZ response (4 res floats) staged in shared memory
// by each block of 256 lanes for the search and the lerps; keys written as
// 16-byte stores, the block's directions through shared memory as one
// coalesced run. At L = 4 each lane computes its packet and writes its
// wavelengths, responses and pdf as 16-byte stores; at L = 1 and 2 each
// float (a warp's stores of a field then fall on contiguous bytes). At every
// other L a lane holding L of each in registers would store them 4L or 12L
// bytes apart across a warp: instead each lane leaves its hero's CDF
// position in shared memory (one float, whatever L), and the block computes
// its run of n_block L packet members in output order, four consecutive
// members a thread (the member's lane a division by the constant L), written
// as 16-byte stores with a scalar tail. Each run starts 1024 L bytes into
// its output, so every vector is aligned; each member is computed once, in
// the same operations, so the outputs are the same bits. On the H100 at
// 1080p (PERF.md §6 row 9w) the block's runs took L = 6 from 0.608 to 0.107 ms
// and L = 16 from 2.637 to 0.251, and were 2-10% slower than the lanes' own
// stores at L = 1 and 2, which keep them. On the H100 at 1080p
// one block per 256 lanes beat a grid of 8 resident blocks per SM striding
// over the lanes (whose table staging it saved), and the staged directions
// beat three 4-byte stores per lane.
//
// What bounds it on the H100: the bytes it writes, 116 per path lane (its
// threefry work, three folds and three draws of 68 and 71 SASS
// instructions, 50 and 51 of them on the integer ALU pipe, is 6.3e8
// ALU-pipe instructions for a 1080p frame, 0.038 ms at that pipe's rate).
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "fast_div.cuh"
#include "packet_width.cuh"
#include "threefry.cuh"

namespace de {

constexpr uint32_t SITE_JITTER = 101u;
constexpr uint32_t SITE_WL = 102u;
constexpr int RAY_THREADS = 256;

// Whether a lane stores its own packet (L = 1, 2, 4), else the block its
// run of packet members (store_packets).
__host__ __device__ constexpr bool lane_stores(int L) { return L <= 2 || L == 4; }

struct RayGenParams {
  float d[3], du[3], dv[3];
  float two_fov, fov, fov_aspect, aspect_scale;
  float seq[3];
  float cdf_max[3];
  float rcp_h, rcp_res, rcp_l;  // float32(1 / b) of the twin's Python divisors
  uint32_t spp_k0, spp_k1, pix_k0, pix_k1;
  uint32_t lane0, n, h, bw, bh;
  FastDiv tile, nby, bh_div;  // bw * bh, h / bh, bh
  int res, preview, stratify;
};

__device__ __forceinline__ float saturate_f(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// Packet member q of a block's run: the lane q / L of the block, its
// wavelength, XYZ response and pdf (the pdf's reciprocal for the preview) at
// rotation q % L of the lane's hero CDF position smid[q / L].
template <int L>
__device__ __forceinline__ void packet_member(const RayGenParams& p, const float* sr,
                                              const float* smid, uint32_t q, float& wl,
                                              float* rs, float& pd) {
  const uint32_t lane = q / L;
  const int l = (int)(q - lane * L);
  float m = smid[lane] + (float)l * p.rcp_l;
  m = m - floorf(m);  // mod 1 (exact for m in [0, 2))
  wl = 390.0f + 441.0f * m;
  const float x = m * (float)p.res - 0.5f;
  const int x0 = min(max((int)floorf(x), 0), p.res - 1);
  const int x1 = min(x0 + 1, p.res - 1);
  const float tt = x - (float)x0;
#pragma unroll
  for (int c = 0; c < 3; ++c) rs[c] = sr[3 * x0 + c] * (1.0f - tt) + sr[3 * x1 + c] * tt;
  const float qv = rs[0] * p.cdf_max[0] + rs[1] * p.cdf_max[1] + rs[2] * p.cdf_max[2];
  const bool ok = (qv > 1e-3f) && isfinite(qv);
  pd = p.preview ? (ok ? 1.0f / fmaxf(qv, 1e-12f) : 0.0f) : (ok ? qv : 0.0f);
}

// The block's runs of its nb lanes' packets (nb L wavelengths and pdf, 3 nb
// L responses, each run at 1024 L bytes a block), four members a thread as
// 16-byte stores, the run's last nb L % 4 members as 4-byte stores.
template <int L>
__device__ __forceinline__ void store_packets(const RayGenParams& p, const float* sr,
                                              const float* smid, uint32_t base, uint32_t nb,
                                              float* __restrict__ wavelengths,
                                              float* __restrict__ responses,
                                              float* __restrict__ pdf) {
  const uint32_t members = nb * L;
  float* __restrict__ wl_run = wavelengths + (size_t)base * L;
  float* __restrict__ pd_run = pdf + (size_t)base * L;
  float* __restrict__ rs_run = responses + 3 * (size_t)base * L;
  for (uint32_t q0 = 4 * threadIdx.x; q0 < members; q0 += 4 * RAY_THREADS) {
    float wl[4], rs[12], pd[4];
    if (q0 + 4 <= members) {
#pragma unroll
      for (int j = 0; j < 4; ++j) packet_member<L>(p, sr, smid, q0 + j, wl[j], rs + 3 * j, pd[j]);
      reinterpret_cast<float4*>(wl_run)[q0 / 4] = make_float4(wl[0], wl[1], wl[2], wl[3]);
      reinterpret_cast<float4*>(pd_run)[q0 / 4] = make_float4(pd[0], pd[1], pd[2], pd[3]);
      float4* r4 = reinterpret_cast<float4*>(rs_run) + 3 * (q0 / 4);
      r4[0] = make_float4(rs[0], rs[1], rs[2], rs[3]);
      r4[1] = make_float4(rs[4], rs[5], rs[6], rs[7]);
      r4[2] = make_float4(rs[8], rs[9], rs[10], rs[11]);
    } else {
      for (uint32_t q = q0; q < members; ++q) {
        packet_member<L>(p, sr, smid, q, wl[0], rs, pd[0]);
        wl_run[q] = wl[0];
        pd_run[q] = pd[0];
#pragma unroll
        for (int c = 0; c < 3; ++c) rs_run[3 * q + c] = rs[c];
      }
    }
  }
}

template <int L>
__global__ void __launch_bounds__(RAY_THREADS)
gen_rays_kernel(const float* __restrict__ g, const float* __restrict__ cie_response,
                int64_t* __restrict__ keys, float* __restrict__ dirs,
                float* __restrict__ wavelengths, float* __restrict__ responses,
                float* __restrict__ pdf, int64_t* __restrict__ pid_out,
                int64_t* __restrict__ tile_out, int64_t* __restrict__ lane_out,
                const int32_t* __restrict__ tile_ids, RayGenParams p) {
  // g (res), then the XYZ response (3 res); where the block stores the
  // packets, then each lane's hero CDF position
  extern __shared__ float tables[];
  __shared__ float sdir[3 * RAY_THREADS];  // the block's directions, stored coalesced
  float* sg = tables;
  float* sr = tables + p.res;
  float* smid = tables + 4 * p.res;
  for (int i = threadIdx.x; i < p.res; i += RAY_THREADS) sg[i] = g[i];
  for (int i = threadIdx.x; i < 3 * p.res; i += RAY_THREADS) sr[i] = cie_response[i];
  __syncthreads();

  const uint32_t base = blockIdx.x * RAY_THREADS;
  const uint32_t i = base + threadIdx.x;
  if (i < p.n) {
    const uint32_t lane = p.lane0 + i;
    const uint32_t t = fast_div(p.tile, lane);
    const uint32_t li = lane - t * p.tile.d;
    const uint32_t tidx = tile_ids ? (uint32_t)tile_ids[t] : t;
    const uint32_t bx = fast_div(p.nby, tidx), by = tidx - bx * p.nby.d;
    const uint32_t lu = fast_div(p.bh_div, li), lv = li - lu * p.bh;
    const uint32_t pu = bx * p.bw + lu, pv = by * p.bh + lv;
    const uint32_t pid = pu * p.h + pv;
    pid_out[i] = (int64_t)pid;
    if (tile_out) {
      tile_out[i] = (int64_t)tidx;
      lane_out[i] = (int64_t)li;
    }

    const Key lk = fold(Key{p.spp_k0, p.spp_k1}, pid);
    reinterpret_cast<longlong2*>(keys)[i] = make_longlong2((int64_t)lk.k0, (int64_t)lk.k1);

    float u3[3];
    if (p.stratify) {
      const Key sk = fold(fold(Key{p.pix_k0, p.pix_k1}, pid), SITE_JITTER);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float x = uniform(sk, (uint32_t)j) + p.seq[j];
        u3[j] = x - floorf(x);  // mod 1 of a value in [0, 2): exact
      }
    } else {
      const Key jk = fold(lk, SITE_JITTER);
      u3[0] = uniform(jk, 0u);
      u3[1] = uniform(jk, 1u);
      u3[2] = uniform(fold(lk, SITE_WL), 0u);
    }

    // cast_dirs
    const float fu =
        ((p.two_fov * ((float)pu + u3[0])) * p.rcp_h - p.fov_aspect - 1e-5f) * p.aspect_scale;
    const float fv = (p.two_fov * ((float)pv + u3[1])) * p.rcp_h - p.fov - 1e-5f;
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = p.d[c] + fu * p.du[c] + fv * p.dv[c];
    const float len = fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), 1e-20f);
#pragma unroll
    for (int c = 0; c < 3; ++c) sdir[3 * threadIdx.x + c] = v[c] / len;

    // CIE inverse CDF (searchsorted side="left")
    const float u = u3[2];
    int lo = 0, hi = p.res;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sg[mid] < u) lo = mid + 1; else hi = mid;
    }
    const int idx = min(max(lo, 1), p.res - 1);
    const float g0 = sg[idx - 1], g1 = sg[idx];
    const float frac = g1 > g0 ? (u - g0) / fmaxf(g1 - g0, 1e-12f) : 0.5f;
    const float mid = ((float)(idx - 1) + 0.5f + saturate_f(frac)) * p.rcp_res;

    if constexpr (lane_stores(L)) {
      float wl[L], rs[3 * L], pd[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        float m = mid + (float)l * p.rcp_l;
        m = m - floorf(m);  // mod 1 (exact for m in [0, 2))
        wl[l] = 390.0f + 441.0f * m;
        const float x = m * (float)p.res - 0.5f;
        const int x0 = min(max((int)floorf(x), 0), p.res - 1);
        const int x1 = min(x0 + 1, p.res - 1);
        const float tt = x - (float)x0;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rs[3 * l + c] = sr[3 * x0 + c] * (1.0f - tt) + sr[3 * x1 + c] * tt;
        const float q = rs[3 * l] * p.cdf_max[0] + rs[3 * l + 1] * p.cdf_max[1] +
                        rs[3 * l + 2] * p.cdf_max[2];
        const bool ok = (q > 1e-3f) && isfinite(q);
        pd[l] = p.preview ? (ok ? 1.0f / fmaxf(q, 1e-12f) : 0.0f) : (ok ? q : 0.0f);
      }
      if constexpr (L == 4) {
        reinterpret_cast<float4*>(wavelengths)[i] = make_float4(wl[0], wl[1], wl[2], wl[3]);
        reinterpret_cast<float4*>(pdf)[i] = make_float4(pd[0], pd[1], pd[2], pd[3]);
        float4* r4 = reinterpret_cast<float4*>(responses) + 3 * (size_t)i;
        r4[0] = make_float4(rs[0], rs[1], rs[2], rs[3]);
        r4[1] = make_float4(rs[4], rs[5], rs[6], rs[7]);
        r4[2] = make_float4(rs[8], rs[9], rs[10], rs[11]);
      } else {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          wavelengths[(size_t)i * L + l] = wl[l];
          pdf[(size_t)i * L + l] = pd[l];
#pragma unroll
          for (int c = 0; c < 3; ++c) responses[((size_t)i * L + l) * 3 + c] = rs[3 * l + c];
        }
      }
    } else {
      smid[threadIdx.x] = mid;
    }
  }
  __syncthreads();
  const uint32_t nb = min((uint32_t)RAY_THREADS, p.n - base);
  const uint32_t m = 3 * nb;
  float* __restrict__ out = dirs + 3 * (size_t)base;
  for (uint32_t k = threadIdx.x; k < m; k += RAY_THREADS) out[k] = sdir[k];
  if constexpr (!lane_stores(L)) {
    store_packets<L>(p, sr, smid, base, nb, wavelengths, responses, pdf);
  }
}

// Dynamic shared memory of gen_rays_kernel<L>: the tables, and where the
// block stores the packets the lanes' hero CDF positions.
template <int L>
size_t ray_shared_bytes(int res) {
  return (4 * (size_t)res + (lane_stores(L) ? 0 : RAY_THREADS)) * sizeof(float);
}

// The largest table the entry takes (4 MAX_RES floats: 48 KiB) with the
// directions' 3 KiB passes the 48 KiB a block has without opting in: past it
// (res 2881 on) opt in to the most any res needs, once per device (so that a
// CUDA graph captures no attribute call).
constexpr int MAX_RES = 3072;

template <int L>
int opt_in_shared() {
  static std::atomic<uint64_t> done{0};  // bit d: device d opted in
  int d = 0;
  cudaError_t rc = cudaGetDevice(&d);
  if (rc != cudaSuccess) return (int)rc;
  if (d < 64 && (done.load() >> d & 1u)) return 0;
  rc = cudaFuncSetAttribute(gen_rays_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)ray_shared_bytes<L>(MAX_RES));
  if (rc == cudaSuccess && d < 64) done.fetch_or(uint64_t{1} << d);
  return (int)rc;
}

template <int L>
int launch_gen_rays(const float* g, const float* cie_response, int64_t* keys, float* dirs,
                    float* wavelengths, float* responses, float* pdf, int64_t* pid,
                    int64_t* tile_index, int64_t* lane_index, const int32_t* tile_ids,
                    const RayGenParams& p, cudaStream_t stream) {
  const uint32_t grid = (p.n + RAY_THREADS - 1) / RAY_THREADS;
  const size_t shared = ray_shared_bytes<L>(p.res);
  if (shared + 3 * RAY_THREADS * sizeof(float) > 48 * 1024) {
    if (int rc = opt_in_shared<L>()) return rc;
  }
  gen_rays_kernel<L><<<grid, RAY_THREADS, shared, stream>>>(
      g, cie_response, keys, dirs, wavelengths, responses, pdf, pid, tile_index, lane_index,
      tile_ids, p);
  return (int)cudaGetLastError();
}

}  // namespace de

// fp: d[3], du[3], dv[3], two_fov, fov, fov_aspect, aspect_scale, seq[3],
//     cdf_max[3] (19 floats)
// ip: spp_k0, spp_k1, pix_k0, pix_k1, lane0, w, h, bw, bh, res, n_lambdas,
//     preview, stratify (13 int64; stratify 1: the R3 point under the
//     pixel's shift, 0: independent uniforms from the lane key)
// keys (n, 2) int64, dirs (n, 3), wavelengths (n, L), responses (n, L, 3),
// pdf (n, L), pid (n,) int64; tile_index, lane_index (n,) int64 or null;
// tile_ids: int32 tile list on the device, or null for consecutive tiles.
// L is a width the library holds (packet_width.cuh); lane0 + n < 2^31; 2 <=
// res <= 3072 (4 res floats, 48 KiB, with the directions' 3 KiB and at L = 3
// or L > 4 the lanes' 1 KiB, in a block's shared memory); the outputs are 16-byte
// aligned (PyTorch's allocations are).
extern "C" int de_gen_rays(const float* fp, const int64_t* ip, const float* g,
                           const float* cie_response, int64_t* keys, float* dirs,
                           float* wavelengths, float* responses, float* pdf, int64_t* pid,
                           int64_t* tile_index, int64_t* lane_index, const int32_t* tile_ids,
                           int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t lane0 = ip[4], h = ip[6], bw = ip[7], bh = ip[8], res = ip[9], L = ip[10];
  if (lane0 < 0 || lane0 + n >= (1ll << 31) || bw <= 0 || bh <= 0 || h % bh != 0 || res < 2 ||
      res > de::MAX_RES || !de::holds_width((int)L) ||
      (tile_index == nullptr) != (lane_index == nullptr))
    return (int)cudaErrorInvalidValue;
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
  p.rcp_h = (float)(1.0 / (double)h);
  p.rcp_res = (float)(1.0 / (double)res);
  p.rcp_l = (float)(1.0 / (double)L);
  p.spp_k0 = (uint32_t)ip[0];
  p.spp_k1 = (uint32_t)ip[1];
  p.pix_k0 = (uint32_t)ip[2];
  p.pix_k1 = (uint32_t)ip[3];
  p.lane0 = (uint32_t)lane0;
  p.n = (uint32_t)n;
  p.h = (uint32_t)h;
  p.bw = (uint32_t)bw;
  p.bh = (uint32_t)bh;
  p.tile = de::make_fast_div((uint32_t)(bw * bh));
  p.nby = de::make_fast_div((uint32_t)(h / bh));
  p.bh_div = de::make_fast_div((uint32_t)bh);
  p.res = (int)res;
  p.preview = (int)ip[11];
  p.stratify = (int)ip[12];
  cudaStream_t s = (cudaStream_t)stream;
  return de::with_width((int)L, [&](auto width) {
    return de::launch_gen_rays<decltype(width)::value>(g, cie_response, keys, dirs, wavelengths,
                                                       responses, pdf, pid, tile_index,
                                                       lane_index, tile_ids, p, s);
  });
}
