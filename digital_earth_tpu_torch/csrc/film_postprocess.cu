// film_postprocess: the per-pixel display chain, one thread per pixel.
//
// Replaces digital_earth_tpu/render/film.py:438 postprocess with
// opendrt_transform (:237), agx_transform (:387) and camera_response (:411):
// /spp (a scalar or a per-pixel count), vignette, 2^exposure, the display
// transform, the film's response curve, gamma and the sRGB encode, as the
// port's plain twin render/film.postprocess_plain computes them, within
// 1e-4 of its display values.
//
// What bounds it on the H100: its bytes, with its instructions just below.
// A pixel reads 12 bytes (16 with a per-pixel count) and writes 12: 0.0149
// ms at 1920x1080; its OpenDRT chain is about 240 FP32 instructions, a
// fused multiply-add one (0.0149 ms at 132 SMs x 128 a clock), and 22
// special-function operations (reciprocals, square roots and the six pows'
// log2 and exp2: 0.0109 ms at 132 x 16 a clock; chip_smoke.py FILM_OPS,
// FILM_SFU). So the design spends as few
// instructions as the 1e-4 allows: the divisions are the SFU's reciprocal
// and a multiply, the pows its exp2 and log2, the multiply-adds fused, the
// pixel's column an integer multiply-high, AgX's pivot scales computed once
// a thread; and each block stages the film's response column (1024 x 3
// floats of the (1024, films, 3) table) in shared memory once, then walks
// the pixels a grid apart, each thread reading its three floats (a warp's
// loads cover whole lines) and writing its three display values. Measured
// on an H100 80GB HBM3 at 700 W at 1920x1080 (PERF.md): this design 0.040
// ms on the device; the same chain with each chunk of 256 pixels staged in
// shared memory as 16-byte vectors and written back so, 0.052 ms (its
// barriers idle the block between the loads and the chain); the flat
// Triton pass it replaces (accurate pows, the taps from the table in
// global memory), 0.067 ms.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "fast_div.cuh"

namespace de {

constexpr int FILM_BLOCK = 256;        // threads a block
constexpr int FILM_BLOCKS_PER_SM = 4;  // the grid: this many blocks an SM

struct FilmParams {
  float a[9], b[9];  // the display transform's two 3x3 matrices, row-major
  float drt_m, drt_s, drt_ds, drt_clamp, dch_s;  // OpenDRT's tone scale
  float lw[3];                                   // OpenDRT's luminance weights
  float spp, exposure_scale, gamma;
  int drt, has_count, crf_res, n_films, crf_index, w, h;
  int n_pix;
  FastDiv div_h;  // pixel id -> its column x = id / H
};

__device__ __forceinline__ float sat(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// The chain's divisions are the SFU's reciprocal and a multiply
// (__fdividef: 2 ulp; a denominator past 2^126 gives 0), its multiply-adds
// fused; the twin rounds op by op, and the kernel is held to 1e-4 of its
// display values (chip_smoke.py prints the largest difference).
__device__ __forceinline__ float fdiv(float a, float b) { return __fdividef(a, b); }

// x^y for x > 0 as the SFU's exp2 of y log2 x (__powf): a relative error of
// about 2^-22 |y log2 x|, under 1e-5 for the encodes and AgX's curve.
__device__ __forceinline__ float fpow(float x, float y) { return __powf(x, y); }

// 0 where |b| < 1e-4 (film.py _sdiv)
__device__ __forceinline__ float sdiv(float a, float b) {
  const bool small = fabsf(b) < 1e-4f;
  return small ? 0.0f : fdiv(a, small ? 1.0f : b);
}

__device__ __forceinline__ void mat3(const float* m, float& x, float& y, float& z) {
  const float u = fmaf(z, m[2], fmaf(y, m[1], x * m[0]));
  const float v = fmaf(z, m[5], fmaf(y, m[4], x * m[3]));
  const float w = fmaf(z, m[8], fmaf(y, m[7], x * m[6]));
  x = u;
  y = v;
  z = w;
}

__device__ __forceinline__ float agx_scale(float xp, float yp, float power) {
  const float a = powf(2.3f * xp, -power);
  const float b = powf(2.3f * fdiv(xp, yp), power) - 1.0f;
  return powf(a * b, -1.0f / power);
}

// AgX's toe and shoulder scales at the pivot's two sides: functions of
// constants alone, computed once a thread.
struct AgxScales {
  float toe[2], shoulder[2];  // [0] below the pivot, [1] above
};

__device__ __forceinline__ AgxScales agx_scales() {
  const float x_pivot = (float)(10.0 / 16.5);
  AgxScales a;
  for (int above = 0; above < 2; ++above) {
    const float sxp = above ? 1.0f - x_pivot : x_pivot;
    a.toe[above] = agx_scale(sxp, 0.5f, 1.9f);
    a.shoulder[above] = agx_scale(sxp, 0.5f, 3.1f);
  }
  return a;
}

// AgX's log encoding and its toe / shoulder curve for one channel.
__device__ __forceinline__ float agx_curve(const AgxScales& sc, float adjusted) {
  const float x_pivot = (float)(10.0 / 16.5);
  float log_v = log2f(fdiv(fmaxf(adjusted, 1e-10f), 0.18f));
  log_v = fminf(fmaxf(log_v, -10.0f), 6.5f);
  const float x = fdiv(log_v + 10.0f, 16.5f);
  const bool above = x >= x_pivot;
  const float scale = above ? sc.shoulder[1] : -sc.toe[0];
  const float power = above ? 3.1f : 1.9f;
  const float term = fdiv(2.3f * (x - x_pivot), scale);
  const float hyper = fdiv(term, fpow(1.0f + fpow(fabsf(term), power), fdiv(1.0f, power)));
  return fmaf(scale, hyper, 0.5f);
}

// OpenDRT v0.2.2, Rec.709 in and out, linear EOTF, Lp = 100 nits.
__device__ __forceinline__ void opendrt(const FilmParams& p, float& r, float& g, float& b) {
  mat3(p.a, r, g, b);
  mat3(p.b, r, g, b);
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float hr = sdiv(r - mn, mx), hg = sdiv(g - mn, mx), hb = sdiv(b - mn, mx);
  const float nr = fminf(fmaxf(hr - (hg + hb), 0.0f), 2.0f);
  const float ng = fminf(fmaxf(hg - (hr + hb), 0.0f), 2.0f);
  const float nb = fminf(fmaxf(hb - (hr + hg), 0.0f), 2.0f);
  const float wr = p.lw[0] * fmaxf(r, 1e-5f);
  const float wg = p.lw[1] * fmaxf(g, 1e-5f);
  const float wb = p.lw[2] * fmaxf(b, 1e-5f);
  const float lum = sqrtf(fmaf(wb, wb, fmaf(wg, wg, wr * wr)));
  const float rr = sdiv(r, lum), rg = sdiv(g, lum), rb = sdiv(b, lum);
  float ts = fdiv(p.drt_m * lum, lum + p.drt_s);
  ts = ts <= 0.0f ? ts : fmaxf(ts, 1e-12f);  // pow(., contrast 1)
  const float tsq = fmaxf(ts, 1e-12f);
  ts = fdiv(ts <= 0.0f ? ts : tsq * tsq, ts + 0.005f);  // flare 0.005
  ts = ts * p.drt_ds;
  const float ccf = sdiv(1.0f, fmaf(lum, p.dch_s, 1.0f));
  const float toe_ccf = 1.0f * sdiv(lum, lum + 0.0f) * ccf;
  const float hw = 1.0f - ccf;
  const float hsr = hw * nr, hsg = hw * ng, hsb = hw * nb;
  float xr = rr + hsb * -0.2f - hsg * -0.1f;
  float xg = rg + hsr * 0.3f - hsb * -0.2f;
  float xb = rb + hsg * -0.1f - hsr * 0.3f;
  xr = fmaxf(1.0f - toe_ccf + xr * toe_ccf, 0.0f);
  xg = fmaxf(1.0f - toe_ccf + xg * toe_ccf, 0.0f);
  xb = fmaxf(1.0f - toe_ccf + xb * toe_ccf, 0.0f);
  const float rmx = fmaxf(fmaxf(xr, xg), xb);
  const float rmn = fminf(fminf(xr, xg), xb);
  const float rch = sdiv(rmx - rmn, rmx) * ts;
  const float chf = rch <= 0.0f ? rch : sqrtf(fmaxf(rch, 1e-12f));  // pow(., 0.5)
  xr = sdiv(xr, rmx) * chf + xr * (1.0f - chf);
  xg = sdiv(xg, rmx) * chf + xg * (1.0f - chf);
  xb = sdiv(xb, rmx) * chf + xb * (1.0f - chf);
  r = fminf(xr * ts, p.drt_clamp);
  g = fminf(xg * ts, p.drt_clamp);
  b = fminf(xb * ts, p.drt_clamp);
}

__device__ __forceinline__ void agx(const FilmParams& p, const AgxScales& sc, float& r, float& g,
                                    float& b) {
  mat3(p.a, r, g, b);
  mat3(p.b, r, g, b);
  r = sat(agx_curve(sc, r));
  g = sat(agx_curve(sc, g));
  b = sat(agx_curve(sc, b));
  const float lum = r * 0.2126729f + g * 0.7151522f + b * 0.0721750f;
  r = sat(lum + (r - lum) * 1.4f);
  g = sat(lum + (g - lum) * 1.4f);
  b = sat(lum + (b - lum) * 1.4f);
}

// The film's response of channel ch (a lerp of its curve in col, res
// entries, half = 0.5 / res), then gamma and the sRGB encode.
__device__ __forceinline__ float respond(const float* col, int res, float half, int ch, float x,
                                         float gamma) {
  const float t = sat(x);
  const float u = fminf(t + half, 1.0f - half);
  const float xx = u * (float)res - 0.5f;
  const int x0 = min(max((int)floorf(xx), 0), res - 1);
  const int x1 = min(x0 + 1, res - 1);
  const float frac = xx - (float)x0;
  const float cam = sat(fmaf(col[3 * x1 + ch], frac, col[3 * x0 + ch] * (1.0f - frac)));
  const float graded = cam > 0.0f ? fpow(cam, gamma) : 0.0f;
  const float hi = fpow(graded, 1.0f / 2.4f) * 1.055f - 0.055f;
  return sat(graded < 0.0031308f ? graded * 12.92f : hi);
}

// Dynamic shared memory: the response column (3 res floats).
__global__ void __launch_bounds__(FILM_BLOCK, FILM_BLOCKS_PER_SM)
    film_kernel(const float* __restrict__ buf, const float* __restrict__ count,
                const float* __restrict__ crf, float* __restrict__ out, FilmParams p) {
  extern __shared__ float col[];
  const int t = threadIdx.x;
  for (int i = t; i < 3 * p.crf_res; i += FILM_BLOCK)
    col[i] = crf[((i / 3) * p.n_films + p.crf_index) * 3 + i % 3];
  __syncthreads();
  const AgxScales sc = p.drt == 1 ? agx_scales() : AgxScales{};
  const float inv_w = 1.0f / (float)p.w, inv_h = 1.0f / (float)p.h;
  const float half = 0.5f / (float)p.crf_res;
  for (int px = blockIdx.x * FILM_BLOCK + t; px < p.n_pix; px += gridDim.x * FILM_BLOCK) {
    float r = __ldcs(buf + 3 * px), g = __ldcs(buf + 3 * px + 1), b = __ldcs(buf + 3 * px + 2);
    // /spp, vignette (strength 0.9, radius 0, centre (0.5, 0.5)), exposure
    const int x = (int)fast_div(p.div_h, (uint32_t)px);
    const float u = (float)x * inv_w - 0.5f;
    const float v = (float)(px - x * p.h) * inv_h - 0.5f;
    const float darken = 1.0f - 0.9f * fmaxf(sqrtf(fmaf(v, v, u * u)), 0.0f);
    const float s = darken * p.exposure_scale *
                    fdiv(1.0f, p.has_count ? fmaxf(count[px], 1.0f) : p.spp);
    r = r * s;
    g = g * s;
    b = b * s;
    if (p.drt == 0) opendrt(p, r, g, b);
    else if (p.drt == 1) agx(p, sc, r, g, b);
    __stcs(out + 3 * px, respond(col, p.crf_res, half, 0, r, p.gamma));
    __stcs(out + 3 * px + 1, respond(col, p.crf_res, half, 1, g, p.gamma));
    __stcs(out + 3 * px + 2, respond(col, p.crf_res, half, 2, b, p.gamma));
  }
}

}  // namespace de

// fp (29 floats): the matrices A and B (9 each, row-major), OpenDRT's m, s,
//     display scale, clamp, dch / s, luminance weights (3), spp, exposure
//     scale (2^exposure), gamma
// ip (7 ints): drt (0 OpenDRT, 1 AgX, 2 none), has_count, the response
//     table's resolution and films, the film, W, H
// buf (W, H, 3), count (W, H) or null, crf (res, films, 3), out (W, H, 3);
// all float32.
extern "C" int de_film_postprocess(const float* fp, const int* ip, const float* buf,
                                   const float* count, const float* crf, float* out,
                                   void* stream) {
  de::FilmParams p;
  for (int j = 0; j < 9; ++j) {
    p.a[j] = fp[j];
    p.b[j] = fp[9 + j];
  }
  p.drt_m = fp[18];
  p.drt_s = fp[19];
  p.drt_ds = fp[20];
  p.drt_clamp = fp[21];
  p.dch_s = fp[22];
  for (int j = 0; j < 3; ++j) p.lw[j] = fp[23 + j];
  p.spp = fp[26];
  p.exposure_scale = fp[27];
  p.gamma = fp[28];
  p.drt = ip[0];
  p.has_count = ip[1];
  p.crf_res = ip[2];
  p.n_films = ip[3];
  p.crf_index = ip[4];
  p.w = ip[5];
  p.h = ip[6];
  const long long n_pix = (long long)p.w * p.h;
  if (p.crf_res < 1 || p.crf_index < 0 || p.crf_index >= p.n_films || (p.has_count && !count) ||
      n_pix > INT32_MAX - de::FILM_BLOCK)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  p.n_pix = (int)n_pix;
  p.div_h = de::make_fast_div((uint32_t)p.h);
  const int n_chunks = (p.n_pix + de::FILM_BLOCK - 1) / de::FILM_BLOCK;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = std::min(n_chunks, sms * de::FILM_BLOCKS_PER_SM);
  const size_t smem = sizeof(float) * 3 * (size_t)p.crf_res;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(de::film_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
    if (rc != 0) return rc;
  }
  de::film_kernel<<<grid, de::FILM_BLOCK, smem, (cudaStream_t)stream>>>(buf, count, crf, out, p);
  return (int)cudaGetLastError();
}
