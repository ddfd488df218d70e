// preview: the preview raymarcher's whole march_paths, one thread per lane.
//
// Replaces digital_earth_tpu/render/raymarcher.py:91-189 march_paths (one
// jitted program) as the port's plain twin render/raymarcher.
// march_paths_plain computes it. Per lane, in the reference's order:
//   1. the wavelength's constants (:99-117): the sun's and the night lights'
//      Planck terms, the sun irradiance over the sun's cone, the RMO
//      extinctions, the Rayleigh and Mie scattering;
//   2. per bounce b = 0, 1, 2 of a live lane (:128-178): the atmosphere span
//      (rsi), primary_miss at bounce 0, the land march (land_march.cuh; no
//      cap, not any-hit), the sun-cone draw, the 64-step single-scatter
//      march (atmos_march.cuh, warp-cooperative), the in-scatter and
//      throughput updates; on a
//      surface hit the normal (4 taps), the material tap and its albedo
//      spectrum, the night lights, the shadow march toward the sun (not
//      any-hit: the reference's shadow ray marches without it), the direct
//      term brdf * n.l with brdf = albedo * diffuse + specular, and the
//      cosine-weighted bounce with its BRDF (surface.cuh); a lane that
//      leaves the atmosphere or hits no land ends there;
//   3. the miss shading of a primary miss (:181-187): the sun disk against
//      the camera ray, the stars tap (dir_tap) through srgb_to_spectrum; then
//      the finite, non-negative clamp of :189.
// Draws: the tile key is fold(spp_key, tile index) (the key itself for one
// tile of n lanes); bounce b's cone and hemisphere keys are
// fold(fold^b(tile key, 2), 0 | 1), read at the lane's in-tile index li and
// at tile + li, as render/raymarcher._bounce_draws draws them.
// Built with --fmad=false: every step rounds op by op in the twin's order on
// the card (whose land_march and atmos_march calls run these same device
// functions), each masked add of the twin an add of the same term here.
//
// What bounds it on the H100: instruction issue (FP32 and SFU) and
// divergence. A lane reads 32 B (ray direction, wavelength, tile and
// in-tile index; the origin comes by value) and writes 4; the time goes to
// the atmosphere march (64 steps, each with a 16-step sun march where the
// planet does not occlude the sun: four expf and a sqrtf per density) and
// the land march's dependent texture probes. Sky lanes end after one march,
// lanes that miss the atmosphere after its test, and only surface lanes run
// bounces 1-2 and the shadow marches. So every thread of a warp stays in the
// bounce loop to its end, finished lanes and threads past n as inactive, and
// the march is warp-cooperative (atmos_march_warp): at each bounce the warp
// ballots its active lanes and marches them 16 threads to a lane, so a warp
// pays for the lanes it has, not for 64 steps of its slowest lane. The land
// and shadow marches are the bounce entries' warp-cooperative march
// (land_march_warp, land_march.cuh), made by every thread of the warp with
// act set where its lane marches: a bounce's first march runs one thread to
// a lane in the warps the planet fills, the shadow march spreads the
// surface lanes' probes (PERF.md has its times against one thread per lane
// on an H100). The marches are inlined: as non-inlined calls (bounce.cu's
// way) they kept more of the lane's values on the stack across each call
// and ran slower on the card, with the same bits. One launch replaces the
// eager glue's thousands of element-wise launches per frame.
//
// Instances: the default (the march's options compiled in at their
// defaults), its census instance, the options instance (OPTS), whose
// land and shadow marches read TraceConfig.enable_land, bilinear_tracking,
// march_exact_ocean and march_ref_phantom at run time (land_march.cuh; the
// stall patience is a parameter of every instance), and the floor instance
// (OPTS and CERT), whose marches also take the certified floor
// (TraceConfig.march_certified_floor; land_march.cuh CERT) with the
// uncertified floor of its parameters.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "atmos_march.cuh"
#include "land_march.cuh"
#include "spectral.cuh"
#include "surface.cuh"
#include "threefry.cuh"
#include "volume.cuh"

namespace de {

constexpr int PREVIEW_BOUNCES = 3;
constexpr int PREVIEW_BLOCK = 128;

struct PreviewParams {
  float origin[3];  // every lane's origin when pos is null
  float scale, step_floor, stall_thresh;
  float light[3];
  float sun_cos_angle, solid_angle, offset_scale;
  float planck_a, planck_b, planck_k;
  float sun_temperature, nightlight_temperature, nightlight_scale, stars_scale;
  float rayleigh_albedo, aerosol_albedo;
  PhaseConsts pc;
  int march_steps, march_k, patience, bilinear, tile;
  int topo_h, topo_w, mat_h, mat_w, stars_h, stars_w;
  Key key;
  MarchOpts mo;  // the options instance's
};

// The floor instance's parameters: the others', then the uncertified floor
// (the default and options instances keep their parameters' size).
struct PreviewParamsCert : PreviewParams {
  float uncert;
};
template <bool CERT>
using PreviewParamsOf = std::conditional_t<CERT, PreviewParamsCert, PreviewParams>;

// The uncertified floor of an instance's parameters (CERT), else none.
template <bool CERT>
__device__ __forceinline__ float uncert_floor(const PreviewParamsOf<CERT>& p) {
  if constexpr (CERT) return p.uncert;
  else return 0.0f;
}

struct PreviewArgs {
  const float* pos;  // null: every lane starts at PreviewParams::origin
  const float* dir;
  const float* wavelength;
  const int64_t* tile_index;  // null: one tile, the key is the tile key
  const int64_t* lane_index;  // null: the lane's own index
  const uint8_t* topo;
  const uint8_t* material;
  const uint8_t* stars;
  const float* o3;
  const float* srgb2spec;
  float* out;
  int n;
  long long* cycles;  // census instance only: (n, 3) clock64 cycles per lane
};

// The march's options of an instance: the parameters' (OPTS), else none.
template <bool OPTS>
__device__ __forceinline__ const MarchOpts* options(const PreviewParams& p) {
  if constexpr (OPTS) return &p.mo;
  else return nullptr;
}

// CENSUS: the census instance, which also writes each lane's clock64 cycles
// in the land and shadow march calls (which every thread of the warp makes),
// in the march and in all (a.cycles); the
// timed instances compile without it. OPTS: the options instance; CERT
// (with OPTS): the floor instance.
template <bool CENSUS = false, bool OPTS = false, bool CERT = false>
__global__ void __launch_bounds__(PREVIEW_BLOCK)
    preview_kernel(PreviewArgs a, PreviewParamsOf<CERT> p) {
  long long t_land = 0, t_march = 0, t_all = 0, c = 0;
  if constexpr (CENSUS) t_all = clock64();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~31) >= a.n) return;  // the whole warp lies past n
  // every other thread stays to the end: the march needs the full warp
  const bool in = lane < a.n;
  const int l = in ? lane : 0;
  const V3 ray_pos = a.pos ? load3(a.pos, l) : V3{p.origin[0], p.origin[1], p.origin[2]};
  const V3 ray_dir = load3(a.dir, l);
  const float wl = a.wavelength[l];

  // 1. the wavelength's constants
  const float sun_power = plancks(wl, p.sun_temperature, p.planck_a, p.planck_b, p.planck_k);
  const float nl_power =
      plancks(wl, p.nightlight_temperature, p.planck_a, p.planck_b, p.planck_k) *
      p.nightlight_scale;
  const float sun_irr = sun_power * p.solid_angle;
  const float ext[3] = {spectra_extinction_rayleigh(wl), spectra_extinction_mie(wl),
                        spectra_extinction_ozone(wl, a.o3)};
  const float sc0 = ext[0] * p.rayleigh_albedo, sc1 = ext[1] * p.aerosol_albedo;

  Key kb = p.key;
  if (a.tile_index) kb = fold(kb, (uint32_t)a.tile_index[l]);
  const uint32_t li = a.lane_index ? (uint32_t)a.lane_index[l] : (uint32_t)l;
  const uint32_t li2 = (uint32_t)p.tile + li;

  // 2. three deterministic bounces; a lane that leaves the atmosphere or
  // hits no land goes inactive and stays in the loop
  const TexView topo{a.topo, p.topo_h, p.topo_w};
  const TexView material{a.material, p.mat_h, p.mat_w};
  const bool bil = p.bilinear != 0;
  const MarchParams mp{p.topo_h, p.topo_w, p.scale, p.step_floor, p.stall_thresh,
                       p.march_steps, p.march_k, p.patience, 0};
  const V3 light{p.light[0], p.light[1], p.light[2]};
  const float no_cap = __int_as_float(0x7f800000);  // +inf: the twin's march has no t_cap
  float accum = 0.0f, thr = 1.0f;
  V3 pos = ray_pos, dir = ray_dir;
  bool alive = in, primary_miss = false;
  for (int b = 0; b < PREVIEW_BOUNCES && __any_sync(FULL_WARP, alive); ++b) {
    float t_start = 0.0f, t_max = 0.0f, a_far = 0.0f;
    V3 light_dir{0.0f, 0.0f, 0.0f};
    bool crossing = false;  // alive and crossing the atmosphere: marches
    if (alive) {
      if (b > 0) kb = fold(kb, 2u);
      float a_near;
      rsi(pos, dir, ATMOS_UPPER_F, a_near, a_far);
      if (!(a_far >= 0.0f)) {  // leaves the atmosphere: ends (a primary miss at bounce 0)
        primary_miss = b == 0;
        alive = false;
      } else {
        crossing = true;
        t_start = isnan(a_near) ? a_near : fmaxf(a_near, 0.0f);  // torch.clamp
        const Key k_cone = fold(kb, 0u);
        light_dir = sample_cone_oriented(uniform(k_cone, li), uniform(k_cone, li2),
                                         p.sun_cos_angle, light);
      }
    }
    // the land march, every thread of the warp (-1 where a lane does not march)
    if constexpr (CENSUS) c = clock64();
    const float earth = land_march_warp<OPTS, CERT>(a.topo, mp, pos, dir, crossing, no_cap,
                                                    nullptr, options<OPTS>(p),
                                                    uncert_floor<CERT>(p));
    if constexpr (CENSUS) t_land += clock64() - c;
    if (crossing) t_max = earth > 0.0f ? earth : a_far;
    float in_scatter = 0.0f, trans = 1.0f;
    if constexpr (CENSUS) c = clock64();
    atmos_march_warp(alive, pos, dir, t_start, t_max, light_dir, ext, sc0, sc1, p.pc,
                     in_scatter, trans);
    if constexpr (CENSUS) t_march += clock64() - c;
    V3 offset_pos{0.0f, 0.0f, 0.0f};
    bool surface = false;  // alive and on the land: marches toward the sun
    if (alive) {
      accum = accum + thr * in_scatter;
      thr = thr * trans;
      surface = earth > 0.0f;
      alive = surface;  // a sky lane ends after its march
      if (surface) {
        const V3 land_pos = along(pos, earth, dir);
        offset_pos = V3{land_pos.x * p.offset_scale, land_pos.y * p.offset_scale,
                        land_pos.z * p.offset_scale};
      }
    }
    // the shadow march, every thread of the warp
    if constexpr (CENSUS) c = clock64();
    const float shadow = land_march_warp<OPTS, CERT>(a.topo, mp, offset_pos, light_dir, surface,
                                                     no_cap, nullptr, options<OPTS>(p),
                                                     uncert_floor<CERT>(p));
    if constexpr (CENSUS) t_land += clock64() - c;
    if (!surface) continue;

    const V3 land_pos = along(pos, earth, dir);
    const V3 normal = land_normal(topo, land_pos, p.scale, bil);
    const LandMaterial mat = get_land_material(material, land_pos, bil);
    const float albedo = srgb_to_spectrum(a.srgb2spec, mat.albedo, wl);
    accum = accum + (thr * mat.emissive) * nl_power;
    const float visible = shadow < 0.0f ? 1.0f : 0.0f;
    const V3 v{-dir.x, -dir.y, -dir.z};
    const BrdfParts dp = earth_brdf_parts(mat.ocean, mat.bathymetry, v, normal, light_dir);
    const float d_brdf = albedo * dp.diffuse + dp.specular;
    accum = accum + (((thr * visible) * sun_irr) * d_brdf) * dp.n_dot_l;
    const Key k_hemi = fold(kb, 1u);
    const V3 hemi =
        sample_hemisphere_cosine_weighted(uniform(k_hemi, li), uniform(k_hemi, li2), normal);
    const BrdfParts bp = earth_brdf_parts(mat.ocean, mat.bathymetry, v, normal, hemi);
    const float b_brdf = albedo * bp.diffuse + bp.specular;
    dir = hemi;
    pos = offset_pos;
    thr = (thr * b_brdf) * PY(PI_D);
  }
  if (!in) return;

  // 3. miss shading against the camera ray, then the clamp
  if (primary_miss) {
    if (dot(light, ray_dir) > p.sun_cos_angle) accum = accum + sun_power;
    float star_rgb[3];
    dir_tap<3>(a.stars, p.stars_h, p.stars_w, ray_dir.x, ray_dir.y, ray_dir.z, bil, star_rgb);
    const float stars_power = srgb_to_spectrum(a.srgb2spec, star_rgb, wl);
    accum = accum + (stars_power * sun_power) * p.stars_scale;
  }
  a.out[lane] = (isfinite(accum) && accum >= 0.0f) ? accum : 0.0f;
  if constexpr (CENSUS) {
    a.cycles[3 * lane] = t_land;
    a.cycles[3 * lane + 1] = t_march;
    a.cycles[3 * lane + 2] = clock64() - t_all;
  }
}

}  // namespace de

// fp (23 floats): scale, step_floor, stall_thresh, light_direction[3],
//     sun_cos_angle, solid_angle (of the sun's cone), offset_scale
//     (1 + 1e-4 scale / 12000), planck_a, planck_b, planck_k,
//     sun_temperature, nightlight_temperature, nightlight_scale, stars_scale,
//     rayleigh_albedo, aerosol_albedo, rayl_k, mie_e, two_pi, log_term,
//     the uncertified floor (read by the floor instance)
// ip (17 ints): land_march_steps, march_k, march_patience,
//     bilinear_materials, tile (lanes per tile), topography H, W, material H,
//     W, stars H, W; the march options enable_land, bilinear_tracking,
//     march_exact_ocean, march_ref_phantom (each 0 or 1); the certified
//     floor (0 or 1: with it the floor instance runs, fp[22] the uncertified
//     floor and step_floor the certified hop); the instance (1: the options
//     instance; 0: the default, which takes the options' defaults only;
//     every instance takes any march_patience)
// cycles: null, or (n, 3) int64 for the census instance: each lane's
// clock64 cycles in its land and shadow marches, in the march
// and in all.
// key (k0, k1): the spp key with tile_index (n,) int64, or the tile key of
// one tile of n lanes without it; lane_index (n,) int64 the in-tile index,
// or null for the lane's own. Lanes: pos (n, 3), or null with origin (3
// floats on the host) every lane's origin; dir (n, 3), wavelength (n,);
// textures: topography (H, W, 4), material (H, W, 8), stars (H, W, 3)
// uint8; o3_crossec (441,), srgb2spec (300, 3) f32; out (n,) radiance.
extern "C" int de_preview(const float* fp, const int* ip, uint32_t k0, uint32_t k1,
                          const float* origin, const float* pos, const float* dir,
                          const float* wavelength, const int64_t* tile_index,
                          const int64_t* lane_index, const uint8_t* topo,
                          const uint8_t* material, const uint8_t* stars, const float* o3,
                          const float* srgb2spec, float* out, long long* cycles, int n,
                          void* stream) {
  de::PreviewParams p;
  for (int j = 0; j < 3; ++j) p.origin[j] = origin ? origin[j] : 0.0f;
  p.scale = fp[0];
  p.step_floor = fp[1];
  p.stall_thresh = fp[2];
  for (int j = 0; j < 3; ++j) p.light[j] = fp[3 + j];
  p.sun_cos_angle = fp[6];
  p.solid_angle = fp[7];
  p.offset_scale = fp[8];
  p.planck_a = fp[9];
  p.planck_b = fp[10];
  p.planck_k = fp[11];
  p.sun_temperature = fp[12];
  p.nightlight_temperature = fp[13];
  p.nightlight_scale = fp[14];
  p.stars_scale = fp[15];
  p.rayleigh_albedo = fp[16];
  p.aerosol_albedo = fp[17];
  p.pc = de::PhaseConsts{fp[18], fp[19], fp[20], fp[21]};
  p.march_steps = ip[0];
  p.march_k = ip[1];
  p.patience = ip[2];
  p.bilinear = ip[3];
  p.tile = ip[4];
  p.topo_h = ip[5];
  p.topo_w = ip[6];
  p.mat_h = ip[7];
  p.mat_w = ip[8];
  p.stars_h = ip[9];
  p.stars_w = ip[10];
  p.key = de::Key{k0, k1};
  p.mo = de::MarchOpts{ip[11], ip[12], ip[13], ip[14]};
  const int cert = ip[15];
  const int opts = ip[16];
  for (int j = 11; j <= 16; ++j) {
    if (ip[j] != 0 && ip[j] != 1) return (int)cudaErrorInvalidValue;
  }
  // the floor instance takes the options too, and a floor above 0
  if (cert && !(opts && fp[22] > 0.0f)) return (int)cudaErrorInvalidValue;
  if (!opts && !(p.mo.enable == 1 && p.mo.bilinear == 0 && p.mo.exact_ocean == 1 &&
                 p.mo.ref_phantom == 1))
    return (int)cudaErrorInvalidValue;  // the default instance runs the defaults only
  if (opts && cycles) return (int)cudaErrorInvalidValue;  // no census of the options instance
  if (pos == nullptr && origin == nullptr) return (int)cudaErrorInvalidValue;
  const de::PreviewArgs a{pos, dir, wavelength, tile_index, lane_index, topo, material,
                          stars, o3, srgb2spec, out, n, cycles};
  if (n > 0) {
    const int blocks = (n + de::PREVIEW_BLOCK - 1) / de::PREVIEW_BLOCK;
    cudaStream_t st = (cudaStream_t)stream;
    if (cycles) {
      de::preview_kernel<true><<<blocks, de::PREVIEW_BLOCK, 0, st>>>(a, p);
    } else if (cert) {
      de::PreviewParamsCert pc;
      static_cast<de::PreviewParams&>(pc) = p;
      pc.uncert = fp[22];
      de::preview_kernel<false, true, true><<<blocks, de::PREVIEW_BLOCK, 0, st>>>(a, pc);
    } else if (opts) de::preview_kernel<false, true><<<blocks, de::PREVIEW_BLOCK, 0, st>>>(a, p);
    else de::preview_kernel<><<<blocks, de::PREVIEW_BLOCK, 0, st>>>(a, p);
  }
  return (int)cudaGetLastError();
}

// Occupancy of the preview kernel, the default instance (opts 0), the
// options instance (1) or the floor instance (2): out = (resident blocks
// per SM, threads per block, registers per thread, local memory bytes per
// thread).
extern "C" int de_preview_occupancy(int opts, int* out) {
  const void* fn = opts == 2   ? (const void*)de::preview_kernel<false, true, true>
                   : opts == 1 ? (const void*)de::preview_kernel<false, true>
                               : (const void*)de::preview_kernel<>;
  int blocks = 0;
  cudaError_t rc =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, de::PREVIEW_BLOCK, 0);
  if (rc != cudaSuccess) return (int)rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = blocks;
  out[1] = de::PREVIEW_BLOCK;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
