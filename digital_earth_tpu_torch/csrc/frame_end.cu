// frame_end: the end of a frame's wavefront, one thread per lane.
//
// Replaces the frame's end of digital_earth_tpu/render/renderer.py:343-348
// (and the deposit of _render_selected, :503-509): pathtracer.py:2000
// shade_primary_miss, :2035 finalize_radiance, the XYZ contraction, xyz_to_rgb
// and the scatter-add of each lane into its pixel. Per lane, in path mode:
//   1. miss shading of a primary-miss lane: final_denom =
//      max(sum_l lambda_pdf * w_mis, 1e-12); the sun disk (dot(light_dir,
//      dir) > sun_cos_angle) adds throughput * planck(5778 K) / final_denom;
//      the stars tap (bilinear or nearest, texture.cuh) through
//      srgb_to_spectrum adds throughput * stars * planck * STARS_SCALE /
//      final_denom;
//   2. the clamp: a channel that is not finite or is negative becomes 0;
//   3. xyz_c = sum_l radiance_l * responses_lc, rgb = XYZ_TO_RGB xyz, lum;
//   4. the deposit: color[pid] += rgb, and with counts count[pid] += 1,
//      lum2[pid] += lum^2.
// Preview mode (L = 1) skips 1 and 2: xyz_c = (radiance * response_c) * pdf.
// Every step rounds in the order of the plain version
// (render/frame_end.frame_end_plain).
//
// No atomics: a pass gives each pixel at most one lane (the lanes of a
// frame, a chunk or a tile list map one to one onto distinct pixels), so a
// lane owns its pixel's read-modify-write and the sums stay deterministic:
// chunked and adaptive passes stay bit-identical to accumulate().
//
// What bounds it on the H100: bytes. It reads about 73 B per lane (radiance,
// responses, the miss flag, the pixel id), 76 B more for a primary-miss lane
// (direction, throughput, w_mis, lambda_pdf, wavelengths) plus its four stars
// texels, and reads and writes 12 B of colour (8 more with counts) per
// pixel; a few hundred flops per miss lane. One launch per frame or pass
// replaces some 60 element-wise PyTorch launches.
#include <cstdint>

#include <cuda_runtime.h>

#include "spectral.cuh"
#include "texture.cuh"

namespace de {

// The packet widths the per-wavelength arrays hold: up to 8 in the main
// library; a width library past 8 (packet_width.cuh) builds this source
// with its own width, DE_WIDTH.
#if defined(DE_WIDTH) && DE_WIDTH > 8
constexpr int MAX_LAMBDAS = DE_WIDTH;
#else
constexpr int MAX_LAMBDAS = 8;
#endif

struct FrameEndParams {
  float planck_a, planck_b, planck_k, sun_temperature, stars_scale;
  float xyz_to_rgb[9];
  float lum_w[3];
  int n_lambdas, stars_h, stars_w, preview, bilinear;
};

__global__ void frame_end_kernel(
    const float* __restrict__ radiance, const float* __restrict__ responses,
    const float* __restrict__ pdf, const float* __restrict__ throughput,
    const float* __restrict__ w_mis, const float* __restrict__ lambda_pdf,
    const float* __restrict__ wavelength, const float* __restrict__ direction,
    const bool* __restrict__ primary_miss, const float* __restrict__ light_dir,
    const float* __restrict__ sun_cos_angle, const uint8_t* __restrict__ stars,
    const float* __restrict__ srgb2spec, const int64_t* __restrict__ pid,
    float* __restrict__ color, float* __restrict__ count, float* __restrict__ lum2,
    int n, FrameEndParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int L = p.n_lambdas;
  float xyz[3];
  if (p.preview) {
    const float rad = radiance[i], q = pdf[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) xyz[c] = (rad * responses[3 * i + c]) * q;
  } else {
    float rad[MAX_LAMBDAS];
    for (int l = 0; l < L; ++l) rad[l] = radiance[i * L + l];
    // The plain version adds where(mask, value, 0) to every lane; adding 0
    // keeps its rounding (-0 becomes +0).
    float sun_add[MAX_LAMBDAS], stars_add[MAX_LAMBDAS];
    for (int l = 0; l < L; ++l) sun_add[l] = stars_add[l] = 0.0f;
    if (primary_miss[i]) {
      const float dx = direction[3 * i], dy = direction[3 * i + 1], dz = direction[3 * i + 2];
      float denom = lambda_pdf[i * L] * w_mis[i * L];
      for (int l = 1; l < L; ++l) denom = denom + lambda_pdf[i * L + l] * w_mis[i * L + l];
      denom = isnan(denom) ? denom : fmaxf(denom, 1e-12f);  // torch.clamp keeps NaN
      const bool sun_hit =
          light_dir[0] * dx + light_dir[1] * dy + light_dir[2] * dz > sun_cos_angle[0];
      float star_rgb[3];
      dir_tap<3>(stars, p.stars_h, p.stars_w, dx, dy, dz, p.bilinear != 0, star_rgb);
      for (int l = 0; l < L; ++l) {
        const float wl = wavelength[i * L + l];
        const float thr = throughput[i * L + l];
        const float sun = plancks(wl, p.sun_temperature, p.planck_a, p.planck_b, p.planck_k);
        if (sun_hit) sun_add[l] = (thr * sun) / denom;
        const float sp = srgb_to_spectrum(srgb2spec, star_rgb, wl);
        stars_add[l] = (((thr * sp) * sun) * p.stars_scale) / denom;
      }
    }
    for (int l = 0; l < L; ++l) {
      float r = (rad[l] + sun_add[l]) + stars_add[l];
      rad[l] = (isfinite(r) && r >= 0.0f) ? r : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = rad[0] * responses[(i * L) * 3 + c];
      for (int l = 1; l < L; ++l) acc = acc + rad[l] * responses[(i * L + l) * 3 + c];
      xyz[c] = acc;
    }
  }
  float rgb[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    rgb[r] = xyz[0] * p.xyz_to_rgb[3 * r] + xyz[1] * p.xyz_to_rgb[3 * r + 1] +
             xyz[2] * p.xyz_to_rgb[3 * r + 2];
  const int64_t px = pid[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) color[3 * px + c] += rgb[c];
  if (count) {
    const float lum = rgb[0] * p.lum_w[0] + rgb[1] * p.lum_w[1] + rgb[2] * p.lum_w[2];
    count[px] += 1.0f;
    lum2[px] += lum * lum;
  }
}

}  // namespace de

// fp: planck_a, planck_b, planck_k, sun_temperature, stars_scale,
//     xyz_to_rgb[9] (row-major), lum_w[3] (17 floats)
// ip: n_lambdas, stars_h, stars_w, preview, bilinear (5 ints)
// Preview mode reads radiance (n,), responses (n, 3), pdf (n,) and no
// miss-shading input (those pointers may be null); count and lum2 are both
// null or both given.
extern "C" int de_frame_end(const float* fp, const int* ip, const float* radiance,
                            const float* responses, const float* pdf, const float* throughput,
                            const float* w_mis, const float* lambda_pdf,
                            const float* wavelength, const float* direction,
                            const bool* primary_miss, const float* light_dir,
                            const float* sun_cos_angle, const uint8_t* stars,
                            const float* srgb2spec, const int64_t* pid, float* color,
                            float* count, float* lum2, int n, void* stream) {
  de::FrameEndParams p;
  p.planck_a = fp[0];
  p.planck_b = fp[1];
  p.planck_k = fp[2];
  p.sun_temperature = fp[3];
  p.stars_scale = fp[4];
  for (int j = 0; j < 9; ++j) p.xyz_to_rgb[j] = fp[5 + j];
  for (int j = 0; j < 3; ++j) p.lum_w[j] = fp[14 + j];
  p.n_lambdas = ip[0];
  p.stars_h = ip[1];
  p.stars_w = ip[2];
  p.preview = ip[3];
  p.bilinear = ip[4];
  if (p.n_lambdas < 1 || p.n_lambdas > de::MAX_LAMBDAS) return (int)cudaErrorInvalidValue;
  const int block = 256;
  de::frame_end_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      radiance, responses, pdf, throughput, w_mis, lambda_pdf, wavelength, direction,
      primary_miss, light_dir, sun_cos_angle, stars, srgb2spec, pid, color, count, lum2, n, p);
  return (int)cudaGetLastError();
}
