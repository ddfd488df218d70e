// bounce: one bounce of every live lane of the wavefront, one thread per
// lane, in place.
//
// Replaces the body of the TPU loop digital_earth_tpu/render/pathtracer.py:
// 1554-1924 run_bounces (as the port's plain twin render/pathtracer.
// run_bounce_plain computes it for one bounce). Thread t takes lane idx[t] of
// the full-size state, reads it, advances it one bounce and writes it back:
// a lane owns its slots, so there are no atomics, and lanes not in the list
// (the dead ones) are not touched. In order, per lane:
//   1. per-wavelength Rayleigh / Mie / ozone extinctions (volume.cuh);
//   2. march on demand: one nearest topography tap certifies a terrain-free
//      ball; a lane below the cloud slab marches first (land_march.cuh);
//   3. the flight: cloud delta tracking, then RMO delta tracking capped at
//      the cloud event (cloud_track.cuh, rmo_track.cuh); the march after it
//      with t_cap, demotion of an RMO event beyond the land hit and the
//      cloud event's resurrection;
//   4. the hero-packet MIS weight from the density-table segment integral
//      (density_lut.cuh);
//   5. the sun-cone sample; the surface branch: normal (4 bilinear taps),
//      material (1 bilinear tap), albedo spectrum, shadow march (any hit),
//      both BRDF evaluations (surface.cuh);
//   6. sun transmittance: the closed-form RMO term from the table times
//      cloud ratio tracking; the three radiance terms over the MIS
//      denominator;
//   7. the phase sample, Russian roulette past rr_start, and the lane's next
//      work class (0 cloud scatter, 1 gas scatter, 2 surface bounce).
// Every draw follows the reference's key chain (lane key -> bounce -> site
// -> sub-site -> loop iteration; sites pathtracer.py:62-71), so the kernel
// draws the twin's numbers lane by lane. Built with --fmad=false; every step
// rounds as the twin does on the card (volume.cuh states the rules).
//
// What bounds it on the H100: not bytes. A lane reads and writes about 190
// B of state plus a few hundred bytes of texture and table taps, 0.3 ms of
// HBM traffic for 2M lanes; the time goes to the three tracking loops,
// whose trip counts differ lane to lane, so a warp runs at its slowest
// lane's pace. The design keeps every intermediate in registers (one launch
// replaces some 4,900 element-wise launches per bounce) and the three loops
// as non-inlined calls shared by their call sites; regrouping lanes by work
// class (compact_lanes.cu orders the list) narrows the spread within a warp.
// Lane regrouping by physical permutation and a persistent lane queue are
// later work.
#include <cstdint>

#include <cuda_runtime.h>

#include "cloud_track.cuh"
#include "density_lut.cuh"
#include "land_march.cuh"
#include "rmo_track.cuh"
#include "spectral.cuh"
#include "surface.cuh"
#include "threefry.cuh"
#include "volume.cuh"

namespace de {

constexpr int BOUNCE_L = 4;  // wavelengths per hero packet
constexpr int BOUNCE_BLOCK = 128;

struct BounceParams {
  float scale, step_floor, stall_thresh, o3_env_peak;
  float light[3];
  float sun_cos_angle, solid_angle, offset_scale;
  float planck_a, planck_b, planck_k;
  int bounce, rr_start, march_steps, march_k, patience, tracking_steps, tracking_k, bilinear;
  int topo_h, topo_w, mat_h, mat_w, clouds_h, clouds_w;
};

struct BounceState {
  float* pos;
  float* dir;
  const float* wavelength;
  const float* lambda_pdf;
  float* throughput;
  float* radiance;
  float* w_mis;
  bool* alive;
  bool* primary_miss;
  int32_t* work_class;
  const int32_t* keys;
  const int32_t* idx;
  const uint8_t* topo;
  const uint8_t* material;
  const uint8_t* clouds;
  const float* o3;
  const float* srgb2spec;
  const float* table;
  int m, n;  // list entries, lanes
};

// The three loops as calls shared by their call sites (not inlined).
__device__ __noinline__ float march_call(const uint8_t* __restrict__ topo, MarchParams p, V3 o,
                                         V3 d, float cap) {
  return land_march_lane(topo, p, o, d, true, cap);
}

struct CloudOut {
  int event;
  float t, trans;
};

__device__ __noinline__ CloudOut cloud_call(Key key, V3 o, V3 d, float t0, float t1, float ew,
                                            const uint8_t* __restrict__ clouds, int H, int W,
                                            int steps, int k, bool ratio) {
  CloudOut out;
  cloud_track_lane(key, o, d, t0, t1, ew, true, clouds, H, W, steps, k, ratio, out.event,
                   out.t, out.trans);
  return out;
}

// Parametric span of the cloud slab along the ray (intersect_cloud_limits).
__device__ __forceinline__ void cloud_limits(V3 o, V3 d, float land, float& t_start,
                                             float& t_max) {
  const float r = length(o);
  float lo_n, lo_f, up_n, up_f;
  rsi(o, d, CLOUDS_LOWER_F, lo_n, lo_f);
  rsi(o, d, CLOUDS_UPPER_F, up_n, up_f);
  const bool above = r >= CLOUDS_UPPER_F;
  const bool inside = !above && r >= CLOUDS_LOWER_F;
  if (above) {
    t_start = fmaxf(up_n, 0.0f);
    t_max = up_f < 0.0f ? -1.0f : (lo_f >= 0.0f ? lo_n : up_f);
  } else if (inside) {
    t_start = 0.0f;
    t_max = lo_f >= 0.0f ? lo_n : up_f;
  } else {
    t_start = lo_f;
    t_max = land > 0.0f ? -1.0f : up_f;
  }
}

// Atmosphere span clipped by the land hit (_rmo_span).
__device__ __forceinline__ void rmo_span(float a_near, float a_far, float land, float& t_start,
                                         float& t_max) {
  t_start = fmaxf(a_near, 0.0f);
  t_max = a_far < 0.0f ? -1.0f : (land >= 0.0f ? land : a_far);
}

// torch.clamp(x, min=lo), which keeps a NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

template <int L>
__global__ void __launch_bounds__(BOUNCE_BLOCK) bounce_kernel(BounceState s, BounceParams p) {
  const int t_id = blockIdx.x * blockDim.x + threadIdx.x;
  if (t_id >= s.m) return;
  const int lane = s.idx[t_id];
  if (lane < 0 || lane >= s.n) return;  // an id outside the state is not a lane
  const V3 pos = load3(s.pos, lane), dir = load3(s.dir, lane);
  const float inf = __int_as_float(0x7f800000);
  float wl[L], thr[L], wmis[L], ext[L][3];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    wl[l] = s.wavelength[lane * L + l];
    thr[l] = s.throughput[lane * L + l];
    wmis[l] = s.w_mis[lane * L + l];
    ext[l][0] = spectra_extinction_rayleigh(wl[l]);
    ext[l][1] = spectra_extinction_mie(wl[l]);
    ext[l][2] = spectra_extinction_ozone(wl[l], s.o3);
  }
  const float ext_w = p.bounce > 9 ? PY(0.02) : PY(0.1);
  const Key kb = fold(load_key(s.keys, lane), (uint32_t)p.bounce);
  const float scale = p.scale;
  MarchParams mp{p.topo_h, p.topo_w, scale, p.step_floor, p.stall_thresh, p.march_steps,
                 p.march_k, p.patience, 0};

  // 2. march on demand
  float tap[4];
  sphere_tap<4>(s.topo, p.topo_h, p.topo_w, pos, false, tap);
  const float r_len = length(pos);
  const float d_free =
      fmaxf(fmaxf(fminf(r_len - (PLANET_R_F + scale * tap[1]), 25e3f),
                  fminf(r_len - (PLANET_R_F + scale * tap[2]), 115e3f)),
            fminf(r_len - (PLANET_R_F + scale * tap[3]), 8e3f));
  float base_near, base_far;
  rsi(pos, dir, PLANET_R_F, base_near, base_far);
  const float cap_proxy = base_near > 0.0f ? base_near : -1.0f;
  const bool below = r_len < CLOUDS_LOWER_F;
  const float earth_pre = below ? march_call(s.topo, mp, pos, dir, inf) : -1.0f;
  const float land_proxy = below ? earth_pre : cap_proxy;

  // 3. the flight: clouds, then the gases capped at the cloud event
  const Key k_flight = fold(kb, 1u);
  float a_near, a_far;
  rsi(pos, dir, ATMOS_UPPER_F, a_near, a_far);
  float t_start, t_max;
  rmo_span(a_near, a_far, land_proxy, t_start, t_max);
  float c_start, c_max;
  cloud_limits(pos, dir, land_proxy, c_start, c_max);
  const CloudOut cd = cloud_call(fold(k_flight, 2u), pos, dir, c_start, c_max, ext_w, s.clouds,
                                 p.clouds_h, p.clouds_w, p.tracking_steps, p.tracking_k, false);
  const float rmo_cap = cd.event > 0 ? fminf(t_max, cd.t) : t_max;
  int rmo_event, rmo_id;
  float rmo_t;
  rmo_track_lane(fold(k_flight, 1u), pos, dir, t_start, rmo_cap, ext[0][0], ext[0][1],
                 ext[0][2], true, p.tracking_steps, p.tracking_k, p.o3_env_peak, rmo_event,
                 rmo_t, rmo_id);
  const bool take_cloud = cd.event > 0 && rmo_event == 0;
  int event = take_cloud ? cd.event : rmo_event;
  float t_int = take_cloud ? cd.t : rmo_t;
  int iid = take_cloud ? 3 : rmo_id;

  const bool need_march =
      !below && (event == 0 || (iid != 3 && t_int > fmaxf(d_free, 0.0f)));
  float earth = earth_pre;
  if (need_march) earth = march_call(s.topo, mp, pos, dir, event > 0 ? t_int : 1e30f);
  // demote RMO events beyond the land hit; the cloud event takes over
  const bool demote = event > 0 && iid != 3 && earth >= 0.0f && earth <= t_int;
  const bool resurrect = demote && cd.event > 0;
  if (demote) event = resurrect ? cd.event : 0;
  if (resurrect) {
    t_int = cd.t;
    iid = 3;
  }

  // 4. hero-packet MIS weight of this bounce's flight outcome
  float rmo_t0, rmo_t1;
  rmo_span(a_near, a_far, earth, rmo_t0, rmo_t1);
  float t_w = event > 0 ? t_int : (earth > 0.0f ? earth : rmo_t1);
  t_w = fminf(fmaxf(t_w, rmo_t0), fmaxf(rmo_t1, rmo_t0));
  const bool rmo_collision = event > 0 && iid != 3;
  {
    float d_seg[3];
    density_integral_segment(s.table, pos, dir, rmo_t0, fmaxf(t_w, rmo_t0), d_seg);
    float tau[L];
#pragma unroll
    for (int l = 0; l < L; ++l) tau[l] = dot3(ext[l][0], ext[l][1], ext[l][2], d_seg[0], d_seg[1], d_seg[2]);
    const int sp = min(iid, 2);
    const float k0 = clamp_min(ext[0][sp], 1e-20f);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float w = expf(-(tau[l] - tau[0]));
      if (rmo_collision) w = w * (ext[l][sp] / k0);
      wmis[l] = wmis[l] * w;
      thr[l] = thr[l] * w;
    }
  }
  if (p.bounce > 9 && iid == 3) iid = 4;
  float denom = s.lambda_pdf[lane * L] * wmis[0];
#pragma unroll
  for (int l = 1; l < L; ++l) denom = denom + s.lambda_pdf[lane * L + l] * wmis[l];
  denom = clamp_min(denom, 1e-12f);

  // 5. sun cone; surface branch
  const Key k_cone = fold(kb, 2u);
  const V3 light_dir = sample_cone_oriented(uniform(k_cone, 0u), uniform(k_cone, 1u),
                                            p.sun_cos_angle,
                                            V3{p.light[0], p.light[1], p.light[2]});
  const bool scatter = event == 2;
  const bool surface = event == 0 && earth > 0.0f;
  const bool miss = event == 0 && !(earth > 0.0f);
  const V3 int_pos = along(pos, scatter ? t_int : 0.0f, dir);
  float pn, planet_far;
  rsi(int_pos, light_dir, PLANET_R_F, pn, planet_far);
  const bool vol_nee = scatter && !(planet_far > 0.0f);

  V3 offset_pos = pos, hemi_dir{0.0f, 1.0f, 0.0f};
  bool sur_vis = false;
  float emissive = 0.0f, d_term[L], b_brdf[L];
#pragma unroll
  for (int l = 0; l < L; ++l) d_term[l] = b_brdf[l] = 0.0f;
  if (surface) {
    const TexView topo{s.topo, p.topo_h, p.topo_w};
    const TexView material{s.material, p.mat_h, p.mat_w};
    const bool bil = p.bilinear != 0;
    const V3 land_pos = along(pos, earth, dir);
    const V3 normal = land_normal(topo, land_pos, scale, bil);
    const LandMaterial mat = get_land_material(material, land_pos, bil);
    offset_pos = V3{land_pos.x * p.offset_scale, land_pos.y * p.offset_scale,
                    land_pos.z * p.offset_scale};
    MarchParams shadow = mp;
    shadow.any_hit = 1;
    sur_vis = march_call(s.topo, shadow, offset_pos, light_dir, inf) < 0.0f;
    const V3 v{-dir.x, -dir.y, -dir.z};
    const BrdfParts dp = earth_brdf_parts(mat.ocean, mat.bathymetry, v, normal, light_dir);
    const Key k_hemi = fold(kb, 5u);
    hemi_dir = sample_hemisphere_cosine_weighted(uniform(k_hemi, 0u), uniform(k_hemi, 1u), normal);
    const BrdfParts bp = earth_brdf_parts(mat.ocean, mat.bathymetry, v, normal, hemi_dir);
    emissive = mat.emissive;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float albedo = srgb_to_spectrum(s.srgb2spec, mat.albedo, wl[l]);
      d_term[l] = (albedo * dp.diffuse + dp.specular) * dp.n_dot_l;
      b_brdf[l] = albedo * bp.diffuse + bp.specular;
    }
  }
  const bool sur_nee = surface && sur_vis;

  // 6. sun transmittance and the radiance terms
  float trans[L];
#pragma unroll
  for (int l = 0; l < L; ++l) trans[l] = 1.0f;
  if (vol_nee || sur_nee) {
    const V3 nee_origin = surface ? offset_pos : int_pos;
    rmo_transmittance_to_space<L>(s.table, ext, nee_origin, light_dir, trans);
    float n_start, n_max;
    cloud_limits(nee_origin, light_dir, -1.0f, n_start, n_max);
    const CloudOut ct = cloud_call(fold(fold(kb, 3u), 2u), nee_origin, light_dir, n_start, n_max,
                                   ext_w, s.clouds, p.clouds_h, p.clouds_w, p.tracking_steps,
                                   p.tracking_k, true);
#pragma unroll
    for (int l = 0; l < L; ++l) trans[l] = trans[l] * ct.trans;
  }
  const bool reduce_peak = p.bounce > 0;
  const float phase_d = vol_nee ? evaluate_phase(dir, light_dir, iid, reduce_peak) : 0.0f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float sun_irr =
        plancks(wl[l], PY(5778.0), p.planck_a, p.planck_b, p.planck_k) * p.solid_angle;
    // each term added as the twin adds where(mask, term, 0) to every lane
    float rad = s.radiance[lane * L + l];
    rad = rad + (vol_nee ? (((thr[l] * trans[l]) * sun_irr) * phase_d) / denom : 0.0f);
    rad = rad + (surface ? ((thr[l] * emissive) *
                            (plancks(wl[l], PY(2700.0), p.planck_a, p.planck_b, p.planck_k) *
                             PY(1e-4))) / denom
                         : 0.0f);
    rad = rad + (sur_nee ? (((thr[l] * trans[l]) * sun_irr) * d_term[l]) / denom : 0.0f);
    s.radiance[lane * L + l] = rad;
  }

  // 7. the next direction, roulette, work class
  V3 new_dir = dir, new_pos = pos;
  if (scatter) {
    const Key k_phase = fold(kb, 4u);
    float phase_w;
    sample_phase_dir(uniform(k_phase, 0u), uniform(k_phase, 1u), uniform(k_phase, 2u), dir, iid,
                     reduce_peak, new_dir, phase_w);
    new_pos = int_pos;
#pragma unroll
    for (int l = 0; l < L; ++l) thr[l] = thr[l] * phase_w;
  } else if (surface) {
    new_dir = hemi_dir;
    new_pos = offset_pos;
#pragma unroll
    for (int l = 0; l < L; ++l) thr[l] = (thr[l] * b_brdf[l]) * PY(PI_D);
  }
  bool alive = scatter || surface;
  if (p.bounce > p.rr_start) {
    const float p_kill = clamp_min(1.0f - thr[0], 0.05f);
    const bool killed = alive && uniform(fold(kb, 6u), 0u) < p_kill;
    if (alive && !killed) {
#pragma unroll
      for (int l = 0; l < L; ++l) thr[l] = thr[l] / (1.0f - p_kill);
    }
    alive = alive && !killed;
  }
  const bool in_cloud = iid == 3 || iid == 4;
  if (alive) s.work_class[lane] = scatter && in_cloud ? 0 : (scatter ? 1 : 2);
  s.alive[lane] = alive;
  if (miss && p.bounce == 0) s.primary_miss[lane] = true;
  s.pos[3 * lane] = new_pos.x;
  s.pos[3 * lane + 1] = new_pos.y;
  s.pos[3 * lane + 2] = new_pos.z;
  s.dir[3 * lane] = new_dir.x;
  s.dir[3 * lane + 1] = new_dir.y;
  s.dir[3 * lane + 2] = new_dir.z;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    s.throughput[lane * L + l] = thr[l];
    s.w_mis[lane * L + l] = wmis[l];
  }
}

}  // namespace de

// fp (13 floats): scale, step_floor, stall_thresh, o3_env_peak,
//     light_direction[3], sun_cos_angle, solid_angle (of the sun's cone),
//     offset_scale (1 + 1e-4 scale / 12000), planck_a, planck_b, planck_k
// ip (15 ints): n_lambdas, bounce, rr_start, land_march_steps, march_k,
//     march_patience, max_tracking_steps, tracking_k, bilinear_materials,
//     topography H, W, material H, W, clouds H, W
// State (n lanes, read and written in place at the m lanes of idx): pos,
// dir (N, 3); wavelength, lambda_pdf, throughput, radiance, w_mis (N, L);
// alive, primary_miss (N,) bool; work_class (N,) int32; keys (N, 2) int32.
// Tables: topography (H, W, 4), material (H, W, 8), clouds (H, W, 4) uint8;
// o3_crossec (441,), srgb2spec (300, 3), density table (384, 1024, 3) f32.
extern "C" int de_bounce(const float* fp, const int* ip, float* pos, float* dir,
                         const float* wavelength, const float* lambda_pdf, float* throughput,
                         float* radiance, float* w_mis, bool* alive, bool* primary_miss,
                         int32_t* work_class, const int32_t* keys, const int32_t* idx, int m,
                         int n, const uint8_t* topo, const uint8_t* material, const uint8_t* clouds,
                         const float* o3, const float* srgb2spec, const float* table,
                         void* stream) {
  de::BounceParams p;
  p.scale = fp[0];
  p.step_floor = fp[1];
  p.stall_thresh = fp[2];
  p.o3_env_peak = fp[3];
  for (int j = 0; j < 3; ++j) p.light[j] = fp[4 + j];
  p.sun_cos_angle = fp[7];
  p.solid_angle = fp[8];
  p.offset_scale = fp[9];
  p.planck_a = fp[10];
  p.planck_b = fp[11];
  p.planck_k = fp[12];
  if (ip[0] != de::BOUNCE_L) return (int)cudaErrorInvalidValue;
  p.bounce = ip[1];
  p.rr_start = ip[2];
  p.march_steps = ip[3];
  p.march_k = ip[4];
  p.patience = ip[5];
  p.tracking_steps = ip[6];
  p.tracking_k = ip[7];
  p.bilinear = ip[8];
  p.topo_h = ip[9];
  p.topo_w = ip[10];
  p.mat_h = ip[11];
  p.mat_w = ip[12];
  p.clouds_h = ip[13];
  p.clouds_w = ip[14];
  const de::BounceState s{pos, dir, wavelength, lambda_pdf, throughput, radiance, w_mis,
                          alive, primary_miss, work_class, keys, idx, topo, material, clouds,
                          o3, srgb2spec, table, m, n};
  if (m > 0) {
    de::bounce_kernel<de::BOUNCE_L>
        <<<(m + de::BOUNCE_BLOCK - 1) / de::BOUNCE_BLOCK, de::BOUNCE_BLOCK, 0,
           (cudaStream_t)stream>>>(s, p);
  }
  return (int)cudaGetLastError();
}
