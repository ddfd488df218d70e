// The bounce entries' device code and launchers (the C entries are in
// bounce.cu). bounce_flight + bounce_shade: one bounce of every live lane of
// the wavefront, one thread per lane, in place, split at the end of the
// flight; bounce_window: every remaining bounce of a few live lanes in one
// launch.
//
// Replaces the body of the TPU loop digital_earth_tpu/render/pathtracer.py:
// 1554-1924 run_bounces (as the port's plain twin render/pathtracer.
// run_bounce_plain computes it for one bounce). Thread t takes lane idx[t] of
// the full-size state, reads it, advances it and writes it back: a lane owns
// its slots, so there are no atomics, and lanes not in the list (the dead
// ones) are not touched. In order, per lane and bounce:
//   1. the hero wavelength's Rayleigh / Mie / ozone extinctions (volume.cuh);
//   2. march on demand: one nearest topography tap certifies a terrain-free
//      ball; a lane below the cloud slab marches first (land_march.cuh);
//   3. the flight: cloud delta tracking, then RMO delta tracking capped at
//      the cloud event (cloud_track.cuh, rmo_track.cuh); the march after it
//      with t_cap, demotion of an RMO event beyond the land hit and the
//      cloud event's resurrection;
//   -- the flight's outcome (event, interaction id, distance, land hit) --
//   4. every wavelength's extinctions again (pure functions of the
//      wavelength, so bit-equal), the hero-packet MIS weight from the
//      density-table segment integral (density_lut.cuh);
//   5. the sun-cone sample; the surface branch: normal (4 bilinear taps),
//      material (1 bilinear tap), albedo spectrum, shadow march (any hit),
//      both BRDF evaluations (surface.cuh);
//   6. sun transmittance: the gases' term times cloud ratio tracking; the
//      three radiance terms over the MIS denominator. The gases' term is
//      the closed form from the table, or with RATIO (TraceConfig.
//      analytic_transmittance False, the reference's estimator) ratio
//      tracking to space at the packet majorant (rmo_track.cuh
//      rmo_ratio_lane);
//   7. the phase sample, Russian roulette past rr_start, and the lane's next
//      work class (0 cloud scatter, 1 gas scatter, 2 surface bounce).
// Every draw follows the reference's key chain (lane key -> bounce -> site
// -> sub-site -> loop iteration; sites pathtracer.py:62-71), so the kernels
// draw the twin's numbers lane by lane. Built with --fmad=false; every step
// rounds as the twin does on the card (volume.cuh states the rules).
//
// The scene and march options (TraceConfig.enable_clouds, enable_land,
// bilinear_tracking, lazy_march, march_exact_ocean, march_ref_phantom; the
// stall patience is a run-time parameter of every instance) are compiled in
// at their defaults in the default instances, which keep their code: code
// that a warp never runs still costs registers and time there (PERF.md).
// Each (L, RATIO) set also has an options instance (OPTS), which reads them
// from the parameters: no clouds skips both cloud passes, no land all three
// march sites (each a miss with no trips); bilinear tracking filters the
// origin tap of step 2, the march's and the cloud trackers' taps; lazy_march
// false marches first (with every live lane, at the pre-march's census
// site) and caps the flight at the hit, with no march after it and no
// demotion (pathtracer.py:1582-1591).
//
// The options instances also run the reference-faithful naive arm
// (TraceConfig.naive_tracking, naive_march, naive_cloud_tracking and
// naive_shadow; naive.cuh), each flag read where its loop is called, so the
// default instances' code stays as it was: naive_march the plain sphere
// march at the three march sites, with no t_cap (march); naive_shadow it at
// the shadow march alone; naive_cloud_tracking the naive cloud delta pass of
// the flight and ratio pass of the sun's transmittance; naive_tracking (L =
// 1 only; the host refuses it at L = 4) all of these and its own flight
// (naive_flight_warp: march first, the gases over the whole span, then the
// cloud where no gas event lies before the slab, the nearer event winning;
// pathtracer.py:1263-1288). Its sun transmittance of the gases is the ratio
// instance's tracker at one probe an iteration, which is the reference's
// one-step loop draw for draw and bit for bit (naive.cuh); the host asks for
// that instance (render/pathtracer.BounceFrame). Every knob instance (the
// options, estimator and floor sets, which run the options instances' code)
// runs the naive trackers as warp-cooperative steps (naive.cuh
// naive_track_warp), which every thread of the warp calls: naive_tracking's
// flight in naive_flight_warp, and the naive cloud passes of the flight and
// of the sun's transmittance before the lanes' branches
// (naive_cloud_warp_on). Its plain march runs block-cooperatively at the
// shadow march under naive_march and naive_shadow (naive.cuh
// naive_march_block, naive_block_on), in bounce_shade's BLOCK instances,
// whose every thread stays to the march, so that bounce_shade's other
// settings run none of its code; one thread a lane at
// bounce_flight's marches and at the shadow march under naive_tracking,
// where the block's form measured slower (PERF.md), and in bounce_window,
// whose warps may be at different bounces.
//
// The estimator instances (OPTS = INST_ESTIMATOR), a third set beside the
// default and options instances, run the options instances' code and the
// estimator options (TraceConfig.analytic_flight, flight_newton_iters,
// fast_loop_rng, nee_rr_start, nee_rr_prob, cloud_rr_start, cloud_rr_keep,
// nee_off), each read inside a helper behind ``if constexpr (OPTS ==
// INST_ESTIMATOR)``, so the default and options instances' code stays as it
// was (in one set, the options instances' flight spilled 300 B where it had
// spilled 212, and the scene options' s/spp grew up to 18%, PERF.md): analytic_flight the gases' flight by inverting their
// optical depth on the table (flight_analytic.cuh, its steps counted at
// the RMO census site) in place of delta tracking (rmo_flight);
// fast_loop_rng the counter hash of fast_rng.cuh in the accelerated
// trackers (the flight's gases and clouds, the sun's cloud pass and, with
// RATIO, its gases; not in the naive arm's loops); nee_rr_prob below 1 the
// NEE roulette past bounce nee_rr_start (site 7: the sun's track kept with
// that probability, its transmittance times float32(1 / nee_rr_prob);
// nee_gate, nee_weight); cloud_rr_keep below 1 the cloud roulette from
// bounce cloud_rr_start (site 8: a cloud-scattered path kept with that
// probability, its throughput times float32(1 / cloud_rr_keep);
// cloud_roulette); nee_off no sun NEE (the surface lanes occluded before
// the shadow march, which no lane runs; no transmittance).
//
// The floor instances (OPTS = INST_FLOORS), a fourth set, run the
// estimator instances' code and the march floors
// (TraceConfig.march_certified_floor with march_uncert_floor_frac, and
// march_floor_frac_secondary; pathtracer.py:1568-1578), behind ``if
// constexpr (OPTS == INST_FLOORS)``, so the other instances' code stays as
// it was (in the estimator instances the floors added about 1,100 SASS
// instructions to each entry and slowed their flight about 2%, PERF.md): the
// primary marches (the pre-march and the march after the flight) take their
// floor and stall threshold at the bounce from the parameters
// (primary_march_params: bounce 0's, or those past it), per bounce inside a
// launch, so bounce_window takes each bounce's; the shadow march keeps
// BounceParams' floor; and at the certified floor every accelerated march
// runs land_march_warp's CERT instance (march_call_c) with the uncertified
// floor. The naive marches have no floor.
//
// Entries, all over the same device functions flight_lane (1-3) and
// shade_lane (4-7), so every entry gives the same bits. Each is built for
// a packet of L = 4 wavelengths (the default) or L = 1 (TraceConfig.
// hero_lambdas), and bounce_shade and bounce_window also for RATIO, so that
// the default instances keep their code and registers, and each of these
// (L, RATIO) sets again with OPTS, as options, estimator and floor
// instances. Each (L, RATIO, OPTS) set of instances is built in a source of
// its own, which nvcc compiles in parallel with the others: bounce.cu (4,
// closed form), bounce_l1.cu (1, closed form), bounce_ratio.cu (4, ratio),
// bounce_l1_ratio.cu (1, ratio), their options sets bounce_opts.cu,
// bounce_l1_opts.cu, bounce_ratio_opts.cu and bounce_l1_ratio_opts.cu, their
// estimator sets bounce_est.cu, bounce_l1_est.cu, bounce_ratio_est.cu and
// bounce_l1_ratio_est.cu, and their floor sets bounce_floor.cu,
// bounce_l1_floor.cu, bounce_ratio_floor.cu and bounce_l1_ratio_floor.cu.
//   - bounce_flight (steps 1-3, the outcome to a 16 B scratch entry per
//     list entry) and bounce_shade (steps 4-7): one bounce of the wide
//     wavefront. Split at the flight's end, the flight's loops run without
//     the four-wavelength state live, at 64 registers and 32 resident warps
//     per SM (steps 1-7 in one kernel: 120 and 16, 6.3 ms against the
//     split's 3.1 at 1080p Apollo bounce 0, the same bits; minimum-block
//     variants 4 and 6 of the flight measured within 4% of this one, 8;
//     PERF.md). Their census instances also write each list entry's trip
//     count at the seven loop sites (pre-march, cloud flight, RMO flight,
//     march after: bounce_flight; shadow march, NEE cloud ratio tracking,
//     NEE RMO ratio tracking (RATIO only): bounce_shade) into an (m, 7)
//     int32 array, as the twin's masked loops count them, and, given an
//     (m, 10) int64 array, each entry's clock64 cycles at the seven sites,
//     in each kernel as a whole (columns 7 flight, 8 shade) and in the
//     shade's surface branch (column 9: the normal's four topography taps
//     and the material tap, on the lanes that reach a surface); the timed
//     instances have no such code;
//   - bounce_window: each listed lane from the given bounce to max_bounces
//     or its death, its state in registers, in blocks of 64 threads.
// The live count comes as a device pointer: a warp whose threads all lie at
// or past *n_live returns at once, so the host launches with an upper bound
// it already holds and never waits for the count. The three land marches
// (pre-march, march after the flight, shadow march) are warp-cooperative
// (land_march_warp: a lane's K probes on as many threads as the warp's
// marching lanes leave idle), so every other thread of a warp reaches
// each march call, with no lane or with a lane that does not march there:
// the marches' inputs are set in their branches and the calls made where
// the whole warp passes.
//
// What bounds it on the H100: neither bytes (a lane moves about 200 B of
// state, 0.12 ms for 2M lanes) nor the loops' operations (counted per trip
// in chip_smoke.py, BOUNCE_*_OPS: 0.07 ms), but their divergence: trip counts
// differ lane to lane, so a warp runs at its slowest lane's pace, and the
// wavefront's tail leaves most of the card idle. The design keeps every
// intermediate in registers, lists lanes by work class (compact_lanes.cu),
// carries the tail in one launch (bounce_window), splits the wide bounces
// so that the flight runs at twice the occupancy, and marches land with the
// warp's threads on the marching lanes' probes.
#pragma once
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "cloud_track.cuh"
#include "density_lut.cuh"
#include "fast_rng.cuh"
#include "flight_analytic.cuh"
#include "land_march.cuh"
#include "naive.cuh"
#include "rmo_track.cuh"
#include "spectral.cuh"
#include "surface.cuh"
#include "threefry.cuh"
#include "volume.cuh"

namespace de {

constexpr int BOUNCE_BLOCK = 128;
constexpr int WINDOW_BLOCK = 64;
constexpr int FLIGHT_MIN_BLOCKS = 8;  // resident blocks of 128 per SM: 64 registers
constexpr int BOUNCE_SITES = 7;
enum {
  SITE_PRE_MARCH, SITE_CLOUD, SITE_RMO, SITE_POST_MARCH, SITE_SHADOW, SITE_NEE_CLOUD, SITE_NEE_RMO
};
// The census's cycle columns: the seven sites, then each kernel's whole,
// then the shade's surface branch.
constexpr int CYCLE_COLS = BOUNCE_SITES + 3;
enum { CYC_FLIGHT = BOUNCE_SITES, CYC_SHADE, CYC_SURFACE };

struct BounceParams {
  float scale, step_floor, stall_thresh, o3_env_peak;
  float light[3];
  float sun_cos_angle, solid_angle, offset_scale;
  float planck_a, planck_b, planck_k;
  float max_dens[3];  // the gases' majorant densities (models/volume.MAX_DENS_RMO)
  int n_lambdas, ratio;  // the packet width L; the gases' sun transmittance by ratio tracking
  int bounce, rr_start, march_steps, march_k, patience, tracking_steps, tracking_k, bilinear;
  int topo_h, topo_w, mat_h, mat_w, clouds_h, clouds_w;
};

// The scene and march options, which the options instances read: the
// march's (enable_land, bilinear_tracking, which also filters the cloud
// trackers' and the origin's taps, march_exact_ocean, march_ref_phantom),
// enable_clouds and lazy_march; and the naive arm's four flags.
struct BounceOptions {
  MarchOpts mo;
  int enable_clouds, lazy_march;
  int naive_tracking, naive_march, naive_cloud_tracking, naive_shadow;
};

// The estimator options, which the estimator instances read beside the
// others: nee_w and cloud_w are float32(1 / nee_rr_prob) and float32(1 /
// cloud_rr_keep), the reciprocals of the Python floats.
struct BounceOptionsEst : BounceOptions {
  int analytic_flight, newton_iters, fast_loop_rng, nee_rr_start, cloud_rr_start, nee_off;
  float nee_rr_prob, nee_w, cloud_rr_keep, cloud_w;
};

// The march floors, which the floor instances read beside the others: cert
// (march_certified_floor), the primary marches' step floor and stall
// threshold at bounce 0 (first) and past it (past), and the uncertified
// floor.
struct BounceOptionsFloors : BounceOptionsEst {
  int cert;
  float floor_first, stall_first, floor_past, stall_past, floor_uncert;
};

// An instance's kind, the template argument OPTS: the default instances
// (the options at their defaults, compiled in), the options instances (the
// scene and march options and the naive arm read at run time), the
// estimator instances (those and the estimator options) and the floor
// instances (those and the march floors).
enum { INST_DEFAULT = 0, INST_OPTIONS = 1, INST_ESTIMATOR = 2, INST_FLOORS = 3 };

// An options instance's kernel parameters: the default's, then the
// options; an estimator instance's, the estimator options too; a floor
// instance's, the march floors too. The default
// instances take BounceParams alone: a larger parameter block changed their
// SASS (28 B of padding added 6-122 instructions to the parent's entries),
// so they keep its size, and the options instances keep theirs.
struct BounceParamsOpts : BounceParams {
  BounceOptions o;
};
struct BounceParamsEst : BounceParams {
  BounceOptionsEst o;
};
struct BounceParamsFloors : BounceParams {
  BounceOptionsFloors o;
};
template <int OPTS>
using EntryParams = std::conditional_t<
    OPTS == INST_FLOORS, BounceParamsFloors,
    std::conditional_t<OPTS == INST_ESTIMATOR, BounceParamsEst,
                       std::conditional_t<OPTS == INST_OPTIONS, BounceParamsOpts, BounceParams>>>;

// The options an entry reads: its parameters' (OPTS), or none (the default
// instances read no option).
template <int OPTS>
__device__ __forceinline__ const BounceOptions* entry_options(const EntryParams<OPTS>& p) {
  if constexpr (OPTS != INST_DEFAULT) return &p.o;
  else return nullptr;
}

// The estimator options of an estimator or floor instance's ``op``.
__device__ __forceinline__ const BounceOptionsEst* est(const BounceOptions* op) {
  return static_cast<const BounceOptionsEst*>(op);
}

// The march floors of a floor instance's ``op``.
__device__ __forceinline__ const BounceOptionsFloors* floors(const BounceOptions* op) {
  return static_cast<const BounceOptionsFloors*>(op);
}

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
  const int32_t* n_live;  // the live count on the device, or null: m entries
  const uint8_t* topo;
  const uint8_t* material;
  const uint8_t* clouds;
  const float* o3;
  const float* srgb2spec;
  const float* table;
  int32_t* trips;     // (m, BOUNCE_SITES) trip counts, census instance only
  long long* cycles;  // (m, CYCLE_COLS) clock64 cycles, census instance only (or null)
  int m, n;           // list entries (an upper bound of the live count), lanes
};

// The census instance's clock: tick() before a site, tock() after it writes
// the cycles between into the entry's column (a thread's own clock64: the
// cycles its warp spent there, waiting on its other lanes included).
template <bool COUNT>
__device__ __forceinline__ long long tick() {
  if constexpr (COUNT) return clock64();
  else return 0;
}

template <bool COUNT>
__device__ __forceinline__ void tock(long long* cyc, int col, long long c0) {
  if constexpr (COUNT) {
    if (cyc) cyc[col] = clock64() - c0;
  }
}

// The entries in the list: m, or the live count on the device below it.
__device__ __forceinline__ int list_size(const BounceState& s) {
  return s.n_live ? min(*s.n_live, s.m) : s.m;
}

// The list entry thread t works on, or -1.
__device__ __forceinline__ int list_lane(const BounceState& s, int t) {
  if (t >= list_size(s)) return -1;
  const int lane = s.idx[t];
  return (lane < 0 || lane >= s.n) ? -1 : lane;  // an id outside the state is not a lane
}

// True in every thread of a warp whose threads all lie past the list: it
// returns at once. Every other thread stays to the end of its kernel, with
// or without a lane, since the land march needs the full warp.
__device__ __forceinline__ bool warp_past_list(const BounceState& s, int t) {
  return (t & ~31) >= list_size(s);
}

// The loops as calls shared by their call sites (not inlined; static: each
// source of instances has its own); the census instance's calls also write
// the loop's trip count; the options instance's (_o) take the march's
// options. Every thread of the warp calls the march (land_march_warp), act
// set where its lane marches.
static __device__ __noinline__ float march_call(const uint8_t* __restrict__ topo, MarchParams p,
                                                V3 o, V3 d, bool act, float cap) {
  return land_march_warp(topo, p, o, d, act, cap);
}

static __device__ __noinline__ float march_call_n(const uint8_t* __restrict__ topo, MarchParams p,
                                                  V3 o, V3 d, bool act, float cap, int* iters) {
  return land_march_warp(topo, p, o, d, act, cap, iters);
}

static __device__ __noinline__ float march_call_o(const uint8_t* __restrict__ topo, MarchParams p,
                                                  MarchOpts mo, V3 o, V3 d, bool act, float cap,
                                                  int* iters) {
  return land_march_warp<true>(topo, p, o, d, act, cap, iters, &mo);
}

// The march at the certified floor (land_march.cuh CERT), called by the
// floor instances only.
static __device__ __noinline__ float march_call_c(const uint8_t* __restrict__ topo, MarchParams p,
                                                  MarchOpts mo, float uncert, V3 o, V3 d,
                                                  bool act, float cap, int* iters) {
  return land_march_warp<true, true>(topo, p, o, d, act, cap, iters, &mo, uncert);
}

// The naive arm's march (naive.cuh), called by the knob instances only:
// one thread a lane (bounce_flight's marches, the shadow march under
// naive_tracking, bounce_window, whose warps may be at different bounces),
// or with every thread of a BOUNCE_BLOCK block (naive_march_block:
// bounce_shade's BLOCK instances' shadow march under naive_block_on, launched with
// naive_march_smem<BOUNCE_BLOCK>() bytes of dynamic shared memory).
static __device__ __noinline__ float naive_march_call(const uint8_t* __restrict__ topo,
                                                      MarchParams p, bool bilinear, V3 o, V3 d,
                                                      bool act, int* iters) {
  return naive_march_lane(topo, p.H, p.W, p.scale, p.steps, bilinear, o, d, act, iters);
}

static __device__ __noinline__ float naive_march_block_call(const uint8_t* __restrict__ topo,
                                                            MarchParams p, bool bilinear, V3 o,
                                                            V3 d, bool act, int* iters) {
  return naive_march_block<BOUNCE_BLOCK>(topo, p.H, p.W, p.scale, p.steps, bilinear, o, d, act,
                                         iters);
}

struct NaiveEvent {
  int event, iid;
  float t;
};

// The knob instances' naive trackers, warp-cooperative steps (naive.cuh
// naive_track_warp): every thread of the warp calls them, ``act`` where its
// lane tracks.
template <int SPECIES>
static __device__ __noinline__ NaiveEvent naive_delta_warp_call(Key key, V3 o, V3 d, float t0,
                                                                float t1, float e0, float e1,
                                                                float e2, float max_ext, bool act,
                                                                const uint8_t* __restrict__ clouds,
                                                                int H, int W, bool bilinear,
                                                                int steps, int* iters) {
  const NaiveTrack r = naive_track_warp<SPECIES, false>(key, o, d, t0, t1, e0, e1, e2, max_ext,
                                                        act, clouds, H, W, bilinear, steps,
                                                        iters);
  return NaiveEvent{r.event, r.iid, r.t};
}

static __device__ __noinline__ float naive_cloud_ratio_warp_call(Key key, V3 o, V3 d, float t0,
                                                                 float t1, float ew,
                                                                 float max_ext, bool act,
                                                                 const uint8_t* __restrict__ clouds,
                                                                 int H, int W, bool bilinear,
                                                                 int steps, int* iters) {
  return naive_track_warp<NAIVE_CLOUD, true>(key, o, d, t0, t1, ew, 0.0f, 0.0f, max_ext, act,
                                             clouds, H, W, bilinear, steps, iters).trans;
}

// Whether a knob instance's march at ``site`` is the plain sphere march:
// under naive_march or naive_tracking, and at the shadow march under
// naive_shadow.
__device__ __forceinline__ bool naive_march_on(const BounceOptions* op, int site) {
  return op->naive_march || op->naive_tracking || (site == SITE_SHADOW && op->naive_shadow);
}

// Whether a knob instance's shadow march is the plain march with every
// thread of the block (naive_march_block; the host launches bounce_shade's
// BLOCK instance for it): under naive_march or naive_shadow, but not
// under naive_tracking, whose shade measured slower with it than one thread
// a lane (PERF.md).
__host__ __device__ __forceinline__ bool naive_block_on(const BounceOptions& o) {
  return !o.naive_tracking && (o.naive_march || o.naive_shadow);
}

// True in every thread of a block whose threads all lie past the list:
// bounce_shade's BLOCK instance, whose shadow march takes every thread of
// the block, returns at once only there.
__device__ __forceinline__ bool block_past_list(const BounceState& s, int t) {
  return t - (int)threadIdx.x >= list_size(s);
}

// A warp none of whose lanes marches here skips the call: a miss, no trips
// (and with OPTS every warp where the options ``op`` say no land; in the
// estimator instances at the shadow march under nee_off an occlusion, no
// trips). OPTS: the plain sphere march (naive_march_on), which takes no cap,
// with BLOCK (bounce_shade's BLOCK instances' shadow march) under naive_block_on
// block-cooperative, every thread of the block calling it; in the floor
// instances at the certified floor the CERT march.
template <bool COUNT, int OPTS, bool BLOCK>
__device__ __forceinline__ float march(const uint8_t* __restrict__ topo, const MarchParams& p,
                                       const BounceOptions* op, V3 o, V3 d, bool act, float cap,
                                       int* trips, int site) {
  if constexpr (OPTS >= INST_ESTIMATOR) {
    if (site == SITE_SHADOW && est(op)->nee_off) {  // "occluded": no sun NEE
      if (COUNT && trips) trips[site] = 0;
      return 1.0f;
    }
  }
  if constexpr (OPTS) {
    if (!op->mo.enable) {
      if (COUNT && trips) trips[site] = 0;
      return -1.0f;
    }
    if constexpr (BLOCK) {
      if (naive_block_on(*op)) {  // uniform over the launch
        return naive_march_block_call(topo, p, op->mo.bilinear != 0, o, d, act,
                                      COUNT && trips ? trips + site : nullptr);
      }
    }
  }
  if (!__any_sync(MARCH_FULL_WARP, act)) {
    if (COUNT && trips) trips[site] = 0;
    return -1.0f;
  }
  if constexpr (OPTS) {
    if (naive_march_on(op, site)) {
      return naive_march_call(topo, p, op->mo.bilinear != 0, o, d, act,
                              COUNT && trips ? trips + site : nullptr);
    }
    if constexpr (OPTS == INST_FLOORS) {
      if (floors(op)->cert) {
        return march_call_c(topo, p, op->mo, floors(op)->floor_uncert, o, d, act, cap,
                            COUNT && trips ? trips + site : nullptr);
      }
    }
    return march_call_o(topo, p, op->mo, o, d, act, cap, COUNT && trips ? trips + site : nullptr);
  } else if constexpr (COUNT) {
    return march_call_n(topo, p, o, d, act, cap, trips ? trips + site : nullptr);
  } else {
    return march_call(topo, p, o, d, act, cap);
  }
}

struct CloudOut {
  int event;
  float t, trans;
};

static __device__ __noinline__ CloudOut cloud_call(Key key, V3 o, V3 d, float t0, float t1,
                                                   float ew, const uint8_t* __restrict__ clouds,
                                                   int H, int W, int steps, int k, bool ratio) {
  CloudOut out;
  cloud_track_lane(key, o, d, t0, t1, ew, true, clouds, H, W, steps, k, ratio, out.event,
                   out.t, out.trans);
  return out;
}

static __device__ __noinline__ CloudOut cloud_call_n(Key key, V3 o, V3 d, float t0, float t1,
                                                     float ew, const uint8_t* __restrict__ clouds,
                                                     int H, int W, int steps, int k, bool ratio,
                                                     int* iters) {
  CloudOut out;
  cloud_track_lane(key, o, d, t0, t1, ew, true, clouds, H, W, steps, k, ratio, out.event,
                   out.t, out.trans, iters);
  return out;
}

static __device__ __noinline__ CloudOut cloud_call_o(Key key, V3 o, V3 d, float t0, float t1,
                                                     float ew, const uint8_t* __restrict__ clouds,
                                                     int H, int W, int steps, int k, bool ratio,
                                                     int* iters, bool bilinear) {
  CloudOut out;
  cloud_track_lane<true>(key, o, d, t0, t1, ew, true, clouds, H, W, steps, k, ratio, out.event,
                         out.t, out.trans, iters, bilinear);
  return out;
}

// The estimator instances' cloud tracker at fast_loop_rng: the counter
// hash's draws.
static __device__ __noinline__ CloudOut cloud_call_f(Key key, V3 o, V3 d, float t0, float t1,
                                                     float ew, const uint8_t* __restrict__ clouds,
                                                     int H, int W, int steps, int k, bool ratio,
                                                     int* iters, bool bilinear) {
  CloudOut out;
  cloud_track_lane<true, true>(key, o, d, t0, t1, ew, true, clouds, H, W, steps, k, ratio,
                               out.event, out.t, out.trans, iters, bilinear);
  return out;
}

// The naive cloud pass at the global majorant ew times the cloud density's
// (knob instances): delta tracking's (event, t) or ratio tracking's
// transmittance, warp-cooperative, every thread of the warp calling it,
// ``act`` where its lane takes the pass (a lane that does not keeps (0, t0,
// 1)).
__device__ __forceinline__ CloudOut naive_cloud_warp(Key key, V3 o, V3 d, float t0, float t1,
                                                     float ew, const BounceState& s,
                                                     const BounceParams& p, bool ratio, bool act,
                                                     int* iters, bool bilinear) {
  const float max_ext = ew * CLOUDS_DENSITY_F;
  CloudOut out{0, t0, 1.0f};
  if (ratio) {
    out.trans = naive_cloud_ratio_warp_call(key, o, d, t0, t1, ew, max_ext, act, s.clouds,
                                            p.clouds_h, p.clouds_w, bilinear, p.tracking_steps,
                                            iters);
  } else {
    const NaiveEvent c = naive_delta_warp_call<NAIVE_CLOUD>(key, o, d, t0, t1, ew, 0.0f, 0.0f,
                                                            max_ext, act, s.clouds, p.clouds_h,
                                                            p.clouds_w, bilinear,
                                                            p.tracking_steps, iters);
    out.event = c.event;
    out.t = c.t;
  }
  return out;
}

// Whether a knob instance's naive cloud passes run: they are
// warp-cooperative and so run before their lanes' branches (flight_lane,
// naive_flight_warp, shade_lane).
__device__ __forceinline__ bool naive_cloud_warp_on(const BounceOptions* op) {
  return (op->naive_cloud_tracking || op->naive_tracking) && op->enable_clouds;
}

// OPTS: the knob instance's call, its taps as the options ``op`` say (the
// estimator and floor instances' draws the counter hash's at
// fast_loop_rng); their naive pass runs before (naive_cloud_warp).
template <bool COUNT, int OPTS>
__device__ __forceinline__ CloudOut cloud(Key key, V3 o, V3 d, float t0, float t1, float ew,
                                          const BounceState& s, const BounceParams& p, bool ratio,
                                          int* trips, int site, const BounceOptions* op) {
  if constexpr (OPTS) {
    if constexpr (OPTS >= INST_ESTIMATOR) {
      if (est(op)->fast_loop_rng) {
        return cloud_call_f(key, o, d, t0, t1, ew, s.clouds, p.clouds_h, p.clouds_w,
                            p.tracking_steps, p.tracking_k, ratio,
                            COUNT ? trips + site : nullptr, op->mo.bilinear != 0);
      }
    }
    return cloud_call_o(key, o, d, t0, t1, ew, s.clouds, p.clouds_h, p.clouds_w, p.tracking_steps,
                        p.tracking_k, ratio, COUNT ? trips + site : nullptr,
                        op->mo.bilinear != 0);
  } else if constexpr (COUNT) {
    return cloud_call_n(key, o, d, t0, t1, ew, s.clouds, p.clouds_h, p.clouds_w,
                        p.tracking_steps, p.tracking_k, ratio, trips + site);
  } else {
    return cloud_call(key, o, d, t0, t1, ew, s.clouds, p.clouds_h, p.clouds_w, p.tracking_steps,
                      p.tracking_k, ratio);
  }
}

// The analytic flight (the estimator instances at analytic_flight).
static __device__ __noinline__ NaiveEvent flight_analytic_call(const float* __restrict__ table,
                                                               Key key, V3 o, V3 d, float t0,
                                                               float t1, float e0, float e1,
                                                               float e2, int n_iter,
                                                               int* iters) {
  NaiveEvent out;
  flight_analytic_lane(table, key, o, d, t0, t1, e0, e1, e2, true, n_iter, out.event, out.t,
                       out.iid, iters);
  return out;
}

// The estimator instances' delta tracker of the gases at fast_loop_rng, and
// their sun transmittance of the gases by ratio tracking there (calls: the
// inlined threefry loops stay as the options instances have them).
static __device__ __noinline__ NaiveEvent rmo_track_call_f(Key key, V3 o, V3 d, float t0,
                                                           float t1, float e0, float e1,
                                                           float e2, int steps, int k,
                                                           float o3_env_peak, int* iters) {
  NaiveEvent out;
  rmo_track_lane<true>(key, o, d, t0, t1, e0, e1, e2, true, steps, k, o3_env_peak, out.event,
                       out.t, out.iid, iters);
  return out;
}

template <int L>
static __device__ __noinline__ void rmo_ratio_call_f(Key key, V3 o, V3 d, float t0, float t1,
                                                     const float (&ext)[L][3], float max_ext,
                                                     int steps, int k, float (&trans)[L],
                                                     int* iters) {
  rmo_ratio_lane<L, true>(key, o, d, t0, t1, ext, max_ext, true, steps, k, trans, iters);
}

// The gases' flight of flight_lane (event, t, iid): delta tracking; the
// estimator instances at analytic_flight the inversion of their optical
// depth, at fast_loop_rng delta tracking drawing the counter hash.
template <bool COUNT, int OPTS>
__device__ __forceinline__ void rmo_flight(const BounceState& s, const BounceParams& p,
                                           const BounceOptions* op, Key key, V3 pos, V3 dir,
                                           float t_start, float rmo_cap, float e0, float e1,
                                           float e2, int& rmo_event, float& rmo_t, int& rmo_id,
                                           int* trips) {
  if constexpr (OPTS >= INST_ESTIMATOR) {
    if (est(op)->analytic_flight) {
      const NaiveEvent g = flight_analytic_call(s.table, key, pos, dir, t_start, rmo_cap, e0, e1,
                                                e2, est(op)->newton_iters,
                                                COUNT ? trips + SITE_RMO : nullptr);
      rmo_event = g.event;
      rmo_t = g.t;
      rmo_id = g.iid;
      return;
    }
    if (est(op)->fast_loop_rng) {
      const NaiveEvent g = rmo_track_call_f(key, pos, dir, t_start, rmo_cap, e0, e1, e2,
                                            p.tracking_steps, p.tracking_k, p.o3_env_peak,
                                            COUNT ? trips + SITE_RMO : nullptr);
      rmo_event = g.event;
      rmo_t = g.t;
      rmo_id = g.iid;
      return;
    }
  }
  rmo_track_lane(key, pos, dir, t_start, rmo_cap, e0, e1, e2, true, p.tracking_steps,
                 p.tracking_k, p.o3_env_peak, rmo_event, rmo_t, rmo_id,
                 COUNT ? trips + SITE_RMO : nullptr);
}

// The sun's gases by ratio tracking (RATIO): the estimator instances draw
// the counter hash at fast_loop_rng, but not under naive_tracking, whose
// one-probe loop is the naive arm's (threefry at every setting).
template <bool COUNT, int L, int OPTS>
__device__ __forceinline__ void nee_rmo_ratio(const BounceParams& p, const BounceOptions* op,
                                              Key key, V3 o, V3 d, float t_start, float tm,
                                              const float (&ext)[L][3], float max_ext,
                                              float (&trans)[L], int* trips) {
  if constexpr (OPTS >= INST_ESTIMATOR) {
    if (est(op)->fast_loop_rng && !op->naive_tracking) {
      rmo_ratio_call_f<L>(key, o, d, t_start, tm, ext, max_ext, p.tracking_steps, p.tracking_k,
                          trans, COUNT ? trips + SITE_NEE_RMO : nullptr);
      return;
    }
  }
  rmo_ratio_lane<L>(key, o, d, t_start, tm, ext, max_ext, true, p.tracking_steps, p.tracking_k,
                    trans, COUNT ? trips + SITE_NEE_RMO : nullptr);
}

// The estimator instances: nee_off drops both NEE terms; past bounce
// nee_rr_start with nee_rr_prob below 1 the sun's track is kept where
// uniform(fold(kb, 7)) < nee_rr_prob (pathtracer.py:1802-1830). The other
// instances keep both.
template <int OPTS>
__device__ __forceinline__ void nee_gate(const BounceOptions* op, int bounce, Key kb,
                                         bool& vol_nee, bool& sur_nee) {
  if constexpr (OPTS >= INST_ESTIMATOR) {
    const BounceOptionsEst* e = est(op);
    if (e->nee_off) {
      vol_nee = sur_nee = false;
    } else if (e->nee_rr_prob < 1.0f && bounce > e->nee_rr_start) {
      const bool keep = uniform(fold(kb, 7u), 0u) < e->nee_rr_prob;
      vol_nee = vol_nee && keep;
      sur_nee = sur_nee && keep;
    }
  }
}

// The estimator instances: a kept track's transmittance times float32(1 /
// nee_rr_prob) where the NEE roulette acts.
template <int OPTS, int L>
__device__ __forceinline__ void nee_weight(const BounceOptions* op, int bounce,
                                           float (&trans)[L]) {
  if constexpr (OPTS >= INST_ESTIMATOR) {
    const BounceOptionsEst* e = est(op);
    if (e->nee_rr_prob < 1.0f && bounce > e->nee_rr_start) {
#pragma unroll
      for (int l = 0; l < L; ++l) trans[l] = trans[l] * e->nee_w;
    }
  }
}

// The estimator instances: from bounce cloud_rr_start with cloud_rr_keep
// below 1, a live cloud-scattered path dies where uniform(fold(kb, 8)) >=
// cloud_rr_keep and goes on with its throughput times float32(1 /
// cloud_rr_keep) (pathtracer.py:1884-1895).
template <int OPTS, int L>
__device__ __forceinline__ void cloud_roulette(const BounceOptions* op, int bounce, Key kb,
                                               bool scatter, int iid, bool& alive,
                                               float (&thr)[L]) {
  if constexpr (OPTS >= INST_ESTIMATOR) {
    const BounceOptionsEst* e = est(op);
    if (e->cloud_rr_keep < 1.0f && bounce >= e->cloud_rr_start && alive && scatter &&
        (iid == 3 || iid == 4)) {
      if (uniform(fold(kb, 8u), 0u) >= e->cloud_rr_keep) {
        alive = false;
      } else {
#pragma unroll
        for (int l = 0; l < L; ++l) thr[l] = thr[l] * e->cloud_w;
      }
    }
  }
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

__device__ __forceinline__ MarchParams march_params(const BounceParams& p) {
  return MarchParams{p.topo_h, p.topo_w, p.scale, p.step_floor, p.stall_thresh, p.march_steps,
                     p.march_k, p.patience, 0};
}

// The primary marches' parameters at ``bounce``: the floor instances take
// the march floors' step floor and stall threshold at bounce 0 or past it;
// the others the shadow march's (march_params).
template <int OPTS>
__device__ __forceinline__ MarchParams primary_march_params(const BounceParams& p,
                                                           const BounceOptions* op, int bounce) {
  MarchParams mp = march_params(p);
  if constexpr (OPTS == INST_FLOORS) {
    const BounceOptionsFloors* e = floors(op);
    mp.step_floor = bounce > 0 ? e->floor_past : e->floor_first;
    mp.stall_thresh = bounce > 0 ? e->stall_past : e->stall_first;
  }
  return mp;
}

__device__ __forceinline__ float cloud_ext_w(int bounce) {
  return bounce > 9 ? PY(0.02) : PY(0.1);
}

// The flight's outcome: event (0 none, 1 absorb, 2 scatter), interaction
// id before the multi-scatter relabel, event distance, land hit (-1 none).
struct Flight {
  int event, iid;
  float t_int, earth;
};

// naive_tracking's steps 1-3 (knob instances; pathtracer.py:1582-1591,
// 1263-1288): every live lane marches first (the plain march), then the
// gases are tracked over the whole span to the hit at their global
// majorant (models/volume.max_extinction_rmo, summed left to right), the
// cloud where no gas event lies before the slab, and the nearer event wins;
// no march after the flight, no demotion. The trackers are warp-cooperative
// (naive_delta_warp_call, naive_cloud_warp): every thread of the warp calls
// it, as flight_lane, and takes part in each tracker, act (for the cloud,
// and no gas event before the slab) where its lane tracks. A thread with no
// lane holds lane 0's ray (the entries) and keeps the outcome (0, 0, 0,
// earth).
template <bool COUNT, int OPTS>
__device__ __forceinline__ Flight naive_flight_warp(const BounceState& s, const BounceParams& p,
                                                    const BounceOptions* op, int bounce, bool act,
                                                    V3 pos, V3 dir, float wl0, Key kb, int* trips,
                                                    long long* cyc) {
  long long c0 = tick<COUNT>();
  const float earth = march<COUNT, OPTS, false>(s.topo, march_params(p), op, pos, dir, act,
                                                __int_as_float(0x7f800000), trips,
                                                SITE_PRE_MARCH);
  tock<COUNT>(cyc, SITE_PRE_MARCH, c0);
  Flight f{0, 0, 0.0f, earth};
  const float e0 = spectra_extinction_rayleigh(wl0);
  const float e1 = spectra_extinction_mie(wl0);
  const float e2 = spectra_extinction_ozone(wl0, s.o3);
  const Key k_flight = fold(kb, 1u);
  float a_near, a_far, t_start, t_max;
  rsi(pos, dir, ATMOS_UPPER_F, a_near, a_far);
  rmo_span(a_near, a_far, earth, t_start, t_max);
  c0 = tick<COUNT>();
  const NaiveEvent g = naive_delta_warp_call<NAIVE_RMO>(
      fold(k_flight, 1u), pos, dir, t_start, t_max, e0, e1, e2,
      (e0 * p.max_dens[0] + e1 * p.max_dens[1]) + e2 * p.max_dens[2], act, nullptr, 0, 0, false,
      p.tracking_steps, COUNT && act ? trips + SITE_RMO : nullptr);
  tock<COUNT>(cyc, SITE_RMO, c0);
  if (act) {
    f.event = g.event;
    f.t_int = g.t;
    f.iid = g.iid;
  }
  if (!op->enable_clouds) return f;  // uniform over the launch
  float c_start, c_max;
  cloud_limits(pos, dir, earth, c_start, c_max);
  const bool go = act && (g.event == 0 || g.t > c_start);
  c0 = tick<COUNT>();
  const CloudOut c = naive_cloud_warp(fold(k_flight, 2u), pos, dir, c_start, c_max,
                                      cloud_ext_w(bounce), s, p, false, go,
                                      COUNT && act ? trips + SITE_CLOUD : nullptr,
                                      op->mo.bilinear != 0);
  tock<COUNT>(go ? cyc : nullptr, SITE_CLOUD, c0);
  if (go && c.event > 0 && (c.t < g.t || g.event == 0)) {
    f.event = c.event;
    f.t_int = c.t;
    f.iid = 3;
  }
  return f;
}

// Steps 1-3 of one bounce of a lane at pos along dir with hero wavelength
// wl0 and bounce key kb. Every thread of the warp calls it (the marches
// need the full warp); act false: no lane (its outcome is not used, and it
// runs no tracker). OPTS: the options ``op`` (the header's comment); march
// first (lazy_march false) is the march on demand with every live lane
// marching at the first site, the flight capped at that hit, and no march
// after it nor demotion; naive_tracking its own flight (naive_flight_warp);
// the knob instances' naive cloud pass runs before the lane's branch
// (naive_cloud_warp_on).
template <bool COUNT, int OPTS>
__device__ __forceinline__ Flight flight_lane(const BounceState& s, const BounceParams& p,
                                              const BounceOptions* op, int bounce, bool act,
                                              V3 pos, V3 dir, float wl0, Key kb, int* trips,
                                              long long* cyc) {
  if constexpr (OPTS) {
    if (op->naive_tracking) {
      return naive_flight_warp<COUNT, OPTS>(s, p, op, bounce, act, pos, dir, wl0, kb, trips,
                                            cyc);
    }
  }
  const float inf = __int_as_float(0x7f800000);
  const float ext_w = cloud_ext_w(bounce);
  const float scale = p.scale;
  const MarchParams mp = primary_march_params<OPTS>(p, op, bounce);
  const bool first = OPTS && !op->lazy_march;  // uniform over the launch

  // 2. march on demand
  float tap[4];
  sphere_tap<4>(s.topo, p.topo_h, p.topo_w, pos, OPTS && op->mo.bilinear, tap);
  const float r_len = length(pos);
  const float d_free =
      fmaxf(fmaxf(fminf(r_len - (PLANET_R_F + scale * tap[1]), 25e3f),
                  fminf(r_len - (PLANET_R_F + scale * tap[2]), 115e3f)),
            fminf(r_len - (PLANET_R_F + scale * tap[3]), 8e3f));
  float base_near, base_far;
  rsi(pos, dir, PLANET_R_F, base_near, base_far);
  const float cap_proxy = base_near > 0.0f ? base_near : -1.0f;
  const bool below = r_len < CLOUDS_LOWER_F;
  long long c0 = tick<COUNT>();
  const float earth_pre = march<COUNT, OPTS, false>(s.topo, mp, op, pos, dir,
                                                    act && (first || below), inf, trips,
                                                    SITE_PRE_MARCH);
  tock<COUNT>(cyc, SITE_PRE_MARCH, c0);
  const float land_proxy = (first || below) ? earth_pre : cap_proxy;

  // 3. the flight: clouds, then the gases capped at the cloud event
  Flight f{0, 0, 0.0f, -1.0f};
  CloudOut cd{0, 0.0f, 1.0f};
  // the knob instances' naive cloud pass, with every thread of the warp
  if constexpr (OPTS) {
    if (naive_cloud_warp_on(op)) {  // uniform over the launch
      float c_start, c_max;
      cloud_limits(pos, dir, land_proxy, c_start, c_max);
      c0 = tick<COUNT>();
      cd = naive_cloud_warp(fold(fold(kb, 1u), 2u), pos, dir, c_start, c_max, ext_w, s, p, false,
                            act, COUNT && act ? trips + SITE_CLOUD : nullptr,
                            op->mo.bilinear != 0);
      tock<COUNT>(cyc, SITE_CLOUD, c0);
    }
  }
  if (act) {
    const float e0 = spectra_extinction_rayleigh(wl0);
    const float e1 = spectra_extinction_mie(wl0);
    const float e2 = spectra_extinction_ozone(wl0, s.o3);
    const Key k_flight = fold(kb, 1u);
    float a_near, a_far;
    rsi(pos, dir, ATMOS_UPPER_F, a_near, a_far);
    float t_start, t_max;
    rmo_span(a_near, a_far, land_proxy, t_start, t_max);
    float c_start, c_max;
    cloud_limits(pos, dir, land_proxy, c_start, c_max);
    if constexpr (OPTS) {
      if (op->enable_clouds && !naive_cloud_warp_on(op)) {
        c0 = tick<COUNT>();
        cd = cloud<COUNT, OPTS>(fold(k_flight, 2u), pos, dir, c_start, c_max, ext_w, s, p, false,
                                trips, SITE_CLOUD, op);
        tock<COUNT>(cyc, SITE_CLOUD, c0);
      }
    } else if (!OPTS || op->enable_clouds) {
      c0 = tick<COUNT>();
      cd = cloud<COUNT, OPTS>(fold(k_flight, 2u), pos, dir, c_start, c_max, ext_w, s, p, false,
                              trips, SITE_CLOUD, op);
      tock<COUNT>(cyc, SITE_CLOUD, c0);
    }
    const float rmo_cap = cd.event > 0 ? fminf(t_max, cd.t) : t_max;
    int rmo_event, rmo_id;
    float rmo_t;
    c0 = tick<COUNT>();
    rmo_flight<COUNT, OPTS>(s, p, op, fold(k_flight, 1u), pos, dir, t_start, rmo_cap, e0, e1,
                            e2, rmo_event, rmo_t, rmo_id, trips);
    tock<COUNT>(cyc, SITE_RMO, c0);
    const bool take_cloud = cd.event > 0 && rmo_event == 0;
    f.event = take_cloud ? cd.event : rmo_event;
    f.t_int = take_cloud ? cd.t : rmo_t;
    f.iid = take_cloud ? 3 : rmo_id;
  }

  const bool need_march = !first && act && !below &&
                          (f.event == 0 || (f.iid != 3 && f.t_int > fmaxf(d_free, 0.0f)));
  c0 = tick<COUNT>();
  const float earth_post = march<COUNT, OPTS, false>(s.topo, mp, op, pos, dir, need_march,
                                                     f.event > 0 ? f.t_int : 1e30f, trips,
                                                     SITE_POST_MARCH);
  tock<COUNT>(cyc, SITE_POST_MARCH, c0);
  f.earth = need_march ? earth_post : earth_pre;
  // demote RMO events beyond the land hit; the cloud event takes over
  const bool demote =
      !first && f.event > 0 && f.iid != 3 && f.earth >= 0.0f && f.earth <= f.t_int;
  const bool resurrect = demote && cd.event > 0;
  if (demote) f.event = resurrect ? cd.event : 0;
  if (resurrect) {
    f.t_int = cd.t;
    f.iid = 3;
  }
  return f;
}

// A lane's per-bounce state in registers.
template <int L>
struct LaneRegs {
  V3 pos, dir;
  float wl[L], lpdf[L], thr[L], rad[L], wmis[L];
  bool alive, miss0;  // alive after the bounce; a primary miss at bounce 0
  int wc;             // the next work class, set when alive
};

template <int L>
__device__ __forceinline__ void load_spectral(const BounceState& s, int lane, LaneRegs<L>& r) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    r.wl[l] = s.wavelength[lane * L + l];
    r.lpdf[l] = s.lambda_pdf[lane * L + l];
    r.thr[l] = s.throughput[lane * L + l];
    r.rad[l] = s.radiance[lane * L + l];
    r.wmis[l] = s.w_mis[lane * L + l];
  }
}

template <int L>
__device__ __forceinline__ void store_lane(const BounceState& s, int lane, const LaneRegs<L>& r,
                                           bool wc_set) {
  if (wc_set) s.work_class[lane] = r.wc;
  s.alive[lane] = r.alive;
  if (r.miss0) s.primary_miss[lane] = true;
  s.pos[3 * lane] = r.pos.x;
  s.pos[3 * lane + 1] = r.pos.y;
  s.pos[3 * lane + 2] = r.pos.z;
  s.dir[3 * lane] = r.dir.x;
  s.dir[3 * lane + 1] = r.dir.y;
  s.dir[3 * lane + 2] = r.dir.z;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    s.throughput[lane * L + l] = r.thr[l];
    s.radiance[lane * L + l] = r.rad[l];
    s.w_mis[lane * L + l] = r.wmis[l];
  }
}

// Steps 4-7 of one bounce of the lane in r, given its flight's outcome.
// Every thread of the warp calls it (the shadow march needs the full warp);
// act false: no lane, and r is left as it was. RATIO: the gases' sun
// transmittance by ratio tracking, else the closed form. OPTS: the options
// ``op``; BLOCK: the shadow march's (march).
template <bool COUNT, int L, bool RATIO, int OPTS, bool BLOCK>
__device__ __forceinline__ void shade_lane(const BounceState& s, const BounceParams& p,
                                           const BounceOptions* op, int bounce, bool act,
                                           LaneRegs<L>& r, Key kb, Flight f, int* trips,
                                           long long* cyc) {
  const V3 pos = r.pos, dir = r.dir;
  const float inf = __int_as_float(0x7f800000);
  const float ext_w = cloud_ext_w(bounce);
  const float scale = p.scale;
  float ext[L][3];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    ext[l][0] = spectra_extinction_rayleigh(r.wl[l]);
    ext[l][1] = spectra_extinction_mie(r.wl[l]);
    ext[l][2] = spectra_extinction_ozone(r.wl[l], s.o3);
  }
  int event = f.event, iid = f.iid;
  const float t_int = f.t_int, earth = f.earth;

  // 4. hero-packet MIS weight of this bounce's flight outcome
  float a_near, a_far;
  rsi(pos, dir, ATMOS_UPPER_F, a_near, a_far);
  float rmo_t0, rmo_t1;
  rmo_span(a_near, a_far, earth, rmo_t0, rmo_t1);
  float t_w = event > 0 ? t_int : (earth > 0.0f ? earth : rmo_t1);
  t_w = fminf(fmaxf(t_w, rmo_t0), fmaxf(rmo_t1, rmo_t0));
  const bool rmo_collision = event > 0 && iid != 3;
  if (act) {
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
      r.wmis[l] = r.wmis[l] * w;
      r.thr[l] = r.thr[l] * w;
    }
  }
  if (bounce > 9 && iid == 3) iid = 4;
  float denom = r.lpdf[0] * r.wmis[0];
#pragma unroll
  for (int l = 1; l < L; ++l) denom = denom + r.lpdf[l] * r.wmis[l];
  denom = clamp_min(denom, 1e-12f);

  // 5. sun cone; surface branch
  const Key k_cone = fold(kb, 2u);
  const V3 light_dir = sample_cone_oriented(uniform(k_cone, 0u), uniform(k_cone, 1u),
                                            p.sun_cos_angle,
                                            V3{p.light[0], p.light[1], p.light[2]});
  const bool scatter = event == 2;
  const bool surface = act && event == 0 && earth > 0.0f;
  const bool miss = event == 0 && !(earth > 0.0f);
  const V3 int_pos = along(pos, scatter ? t_int : 0.0f, dir);
  float pn, planet_far;
  rsi(int_pos, light_dir, PLANET_R_F, pn, planet_far);
  bool vol_nee = scatter && !(planet_far > 0.0f);

  V3 offset_pos = pos, hemi_dir{0.0f, 1.0f, 0.0f}, normal{0.0f, 0.0f, 0.0f};
  LandMaterial mat{};
  const long long c_surface = tick<COUNT>();
  if (surface) {
    const TexView topo{s.topo, p.topo_h, p.topo_w};
    const TexView material{s.material, p.mat_h, p.mat_w};
    const bool bil = p.bilinear != 0;
    const V3 land_pos = along(pos, earth, dir);
    normal = land_normal(topo, land_pos, scale, bil);
    mat = get_land_material(material, land_pos, bil);
    offset_pos = V3{land_pos.x * p.offset_scale, land_pos.y * p.offset_scale,
                    land_pos.z * p.offset_scale};
  }
  tock<COUNT>(surface ? cyc : nullptr, CYC_SURFACE, c_surface);
  // the shadow march of the surface lanes, where the whole warp calls it
  MarchParams shadow = march_params(p);
  shadow.any_hit = 1;
  const long long c0 = tick<COUNT>();
  const float shadow_hit =
      march<COUNT, OPTS, BLOCK>(s.topo, shadow, op, offset_pos, light_dir, surface, inf, trips,
                                SITE_SHADOW);
  tock<COUNT>(cyc, SITE_SHADOW, c0);
  // the knob instances' naive cloud pass of the sun's transmittance, with
  // every thread of the warp before those with no lane leave, on the lanes
  // step 6 takes past the estimator instances' NEE gates (nee_gate)
  [[maybe_unused]] float naive_nee = 1.0f;
  if constexpr (OPTS) {
    if (naive_cloud_warp_on(op)) {  // uniform over the launch
      bool vol_go = vol_nee, sur_go = surface && shadow_hit < 0.0f;
      nee_gate<OPTS>(op, bounce, kb, vol_go, sur_go);
      const bool go = vol_go || sur_go;
      const V3 nee_origin = surface ? offset_pos : int_pos;
      float n_start, n_max;
      cloud_limits(nee_origin, light_dir, -1.0f, n_start, n_max);
      const long long c1 = tick<COUNT>();
      naive_nee = naive_cloud_warp(fold(fold(kb, 3u), 2u), nee_origin, light_dir, n_start, n_max,
                                   ext_w, s, p, true, go,
                                   COUNT && act ? trips + SITE_NEE_CLOUD : nullptr,
                                   op->mo.bilinear != 0).trans;
      tock<COUNT>(go ? cyc : nullptr, SITE_NEE_CLOUD, c1);
    }
  }
  if (!act) return;
  const bool sur_vis = surface && shadow_hit < 0.0f;
  float emissive = 0.0f, d_term[L], b_brdf[L];
#pragma unroll
  for (int l = 0; l < L; ++l) d_term[l] = b_brdf[l] = 0.0f;
  if (surface) {
    const V3 v{-dir.x, -dir.y, -dir.z};
    const BrdfParts dp = earth_brdf_parts(mat.ocean, mat.bathymetry, v, normal, light_dir);
    const Key k_hemi = fold(kb, 5u);
    hemi_dir = sample_hemisphere_cosine_weighted(uniform(k_hemi, 0u), uniform(k_hemi, 1u), normal);
    const BrdfParts bp = earth_brdf_parts(mat.ocean, mat.bathymetry, v, normal, hemi_dir);
    emissive = mat.emissive;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float albedo = srgb_to_spectrum(s.srgb2spec, mat.albedo, r.wl[l]);
      d_term[l] = (albedo * dp.diffuse + dp.specular) * dp.n_dot_l;
      b_brdf[l] = albedo * bp.diffuse + bp.specular;
    }
  }
  bool sur_nee = surface && sur_vis;
  nee_gate<OPTS>(op, bounce, kb, vol_nee, sur_nee);

  // 6. sun transmittance and the radiance terms
  float trans[L];
#pragma unroll
  for (int l = 0; l < L; ++l) trans[l] = 1.0f;
  if (vol_nee || sur_nee) {
    const V3 nee_origin = surface ? offset_pos : int_pos;
    const Key k_trans = fold(kb, 3u);
    if constexpr (RATIO) {
      // the packet majorant, each wavelength's sum left to right
      float max_ext = 0.0f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float e = (ext[l][0] * p.max_dens[0] + ext[l][1] * p.max_dens[1]) +
                        ext[l][2] * p.max_dens[2];
        max_ext = l == 0 ? e : fmaxf(max_ext, e);
      }
      float g_near, g_far, g_start, g_max;
      rsi(nee_origin, light_dir, ATMOS_UPPER_F, g_near, g_far);
      rmo_span(g_near, g_far, -1.0f, g_start, g_max);
      const long long c2 = tick<COUNT>();
      nee_rmo_ratio<COUNT, L, OPTS>(p, op, fold(k_trans, 1u), nee_origin, light_dir, g_start,
                                    g_max, ext, max_ext, trans, trips);
      tock<COUNT>(cyc, SITE_NEE_RMO, c2);
    } else {
      rmo_transmittance_to_space<L>(s.table, ext, nee_origin, light_dir, trans);
    }
    if constexpr (OPTS) {
      if (naive_cloud_warp_on(op)) {
#pragma unroll
        for (int l = 0; l < L; ++l) trans[l] = trans[l] * naive_nee;
      } else if (op->enable_clouds) {
        float n_start, n_max;
        cloud_limits(nee_origin, light_dir, -1.0f, n_start, n_max);
        const long long c1 = tick<COUNT>();
        const CloudOut ct = cloud<COUNT, OPTS>(fold(k_trans, 2u), nee_origin, light_dir, n_start,
                                             n_max, ext_w, s, p, true, trips, SITE_NEE_CLOUD,
                                             op);
        tock<COUNT>(cyc, SITE_NEE_CLOUD, c1);
#pragma unroll
        for (int l = 0; l < L; ++l) trans[l] = trans[l] * ct.trans;
      }
    } else if (!OPTS || op->enable_clouds) {
      float n_start, n_max;
      cloud_limits(nee_origin, light_dir, -1.0f, n_start, n_max);
      const long long c1 = tick<COUNT>();
      const CloudOut ct = cloud<COUNT, OPTS>(fold(k_trans, 2u), nee_origin, light_dir, n_start,
                                           n_max, ext_w, s, p, true, trips, SITE_NEE_CLOUD, op);
      tock<COUNT>(cyc, SITE_NEE_CLOUD, c1);
#pragma unroll
      for (int l = 0; l < L; ++l) trans[l] = trans[l] * ct.trans;
    }
    nee_weight<OPTS>(op, bounce, trans);
  }
  const bool reduce_peak = bounce > 0;
  const float phase_d = vol_nee ? evaluate_phase(dir, light_dir, iid, reduce_peak) : 0.0f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float sun_irr =
        plancks(r.wl[l], PY(5778.0), p.planck_a, p.planck_b, p.planck_k) * p.solid_angle;
    // each term added as the twin adds where(mask, term, 0) to every lane
    float rad = r.rad[l];
    rad = rad + (vol_nee ? (((r.thr[l] * trans[l]) * sun_irr) * phase_d) / denom : 0.0f);
    rad = rad + (surface ? ((r.thr[l] * emissive) *
                            (plancks(r.wl[l], PY(2700.0), p.planck_a, p.planck_b, p.planck_k) *
                             PY(1e-4))) / denom
                         : 0.0f);
    rad = rad + (sur_nee ? (((r.thr[l] * trans[l]) * sun_irr) * d_term[l]) / denom : 0.0f);
    r.rad[l] = rad;
  }

  // 7. the next direction, roulette, work class
  if (scatter) {
    const Key k_phase = fold(kb, 4u);
    float phase_w;
    V3 new_dir;
    sample_phase_dir(uniform(k_phase, 0u), uniform(k_phase, 1u), uniform(k_phase, 2u), dir, iid,
                     reduce_peak, new_dir, phase_w);
    r.dir = new_dir;
    r.pos = int_pos;
#pragma unroll
    for (int l = 0; l < L; ++l) r.thr[l] = r.thr[l] * phase_w;
  } else if (surface) {
    r.dir = hemi_dir;
    r.pos = offset_pos;
#pragma unroll
    for (int l = 0; l < L; ++l) r.thr[l] = (r.thr[l] * b_brdf[l]) * PY(PI_D);
  }
  bool alive = scatter || surface;
  if (bounce > p.rr_start) {
    const float p_kill = clamp_min(1.0f - r.thr[0], 0.05f);
    const bool killed = alive && uniform(fold(kb, 6u), 0u) < p_kill;
    if (alive && !killed) {
#pragma unroll
      for (int l = 0; l < L; ++l) r.thr[l] = r.thr[l] / (1.0f - p_kill);
    }
    alive = alive && !killed;
  }
  cloud_roulette<OPTS>(op, bounce, kb, scatter, iid, alive, r.thr);
  const bool in_cloud = iid == 3 || iid == 4;
  if (alive) r.wc = scatter && in_cloud ? 0 : (scatter ? 1 : 2);
  r.alive = alive;
  r.miss0 = r.miss0 || (miss && bounce == 0);
}

template <int L>
__device__ __forceinline__ Key bounce_key(const BounceState& s, int lane, int bounce) {
  return fold(load_key(s.keys, lane), (uint32_t)bounce);
}

// The census instance's trip counts of list entry t, sites [lo, hi) set
// to 0; null in the timed instance.
template <bool COUNT>
__device__ __forceinline__ int* entry_trips(const BounceState& s, int t, int lo, int hi) {
  if constexpr (COUNT) {
    int* trips = s.trips + BOUNCE_SITES * t;
    for (int j = lo; j < hi; ++j) trips[j] = 0;
    return trips;
  } else {
    return nullptr;
  }
}

// The census instance's cycle columns of list entry t, [lo, hi) set to 0
// (a site a lane skips stays 0); null in the timed instance or without a
// cycles array.
template <bool COUNT>
__device__ __forceinline__ long long* entry_cycles(const BounceState& s, int t, int lo, int hi) {
  if constexpr (COUNT) {
    if (!s.cycles) return nullptr;
    long long* cyc = s.cycles + CYCLE_COLS * t;
    for (int j = lo; j < hi; ++j) cyc[j] = 0;
    return cyc;
  } else {
    return nullptr;
  }
}

// Steps 1-3 of one bounce: the outcome of list entry t into out[t]
// (t_int, earth, event, iid as float bits); COUNT: the census instance
// (sites 0-3); OPTS: the options instance.
template <int L, bool COUNT, int OPTS>
__global__ void __launch_bounds__(BOUNCE_BLOCK, FLIGHT_MIN_BLOCKS)
    bounce_flight_kernel(BounceState s, EntryParams<OPTS> p, float4* __restrict__ out) {
  const long long c_all = tick<COUNT>();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (warp_past_list(s, t)) return;
  const int lane = list_lane(s, t);
  const bool act = lane >= 0;
  const int l = act ? lane : 0;  // a thread with no lane reads lane 0 and writes nothing
  int* trips = act ? entry_trips<COUNT>(s, t, SITE_PRE_MARCH, SITE_SHADOW) : nullptr;
  long long* cyc = act ? entry_cycles<COUNT>(s, t, SITE_PRE_MARCH, SITE_SHADOW) : nullptr;
  const Flight f = flight_lane<COUNT, OPTS>(s, p, entry_options<OPTS>(p), p.bounce, act,
                                            load3(s.pos, l), load3(s.dir, l), s.wavelength[l * L],
                                            bounce_key<L>(s, l, p.bounce), trips, cyc);
  if (act) out[t] = make_float4(f.t_int, f.earth, __int_as_float(f.event), __int_as_float(f.iid));
  tock<COUNT>(cyc, CYC_FLIGHT, c_all);
}

// Steps 4-7 of one bounce from bounce_flight's outcome; COUNT: the census
// instance (sites 4-6); OPTS: the options instance. BLOCK (a knob instance
// under naive_block_on; naive_march_smem<BOUNCE_BLOCK>() bytes of dynamic
// shared memory): the naive shadow march block-cooperative, every thread of
// the block staying to it, a block wholly past the list returning at once.
template <int L, bool COUNT, bool RATIO, int OPTS, bool BLOCK = false>
__global__ void __launch_bounds__(BOUNCE_BLOCK)
    bounce_shade_kernel(BounceState s, EntryParams<OPTS> p, const float4* __restrict__ in) {
  static_assert(!BLOCK || OPTS != INST_DEFAULT, "the default instances run no naive march");
  const long long c_all = tick<COUNT>();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (BLOCK ? block_past_list(s, t) : warp_past_list(s, t)) return;
  const int lane = list_lane(s, t);
  const bool act = lane >= 0;
  const int l = act ? lane : 0;  // a thread with no lane reads lane 0 and writes nothing
  int* trips = act ? entry_trips<COUNT>(s, t, SITE_SHADOW, BOUNCE_SITES) : nullptr;
  long long* cyc = act ? entry_cycles<COUNT>(s, t, SITE_SHADOW, BOUNCE_SITES) : nullptr;
  if constexpr (COUNT) {
    if (cyc) cyc[CYC_SURFACE] = 0;  // written where the lane reaches a surface
  }
  const float4 o = act ? in[t] : make_float4(0.0f, -1.0f, 0.0f, 0.0f);
  const Flight f{__float_as_int(o.z), __float_as_int(o.w), o.x, o.y};
  LaneRegs<L> r;
  r.pos = load3(s.pos, l);
  r.dir = load3(s.dir, l);
  r.miss0 = false;
  load_spectral(s, l, r);
  shade_lane<COUNT, L, RATIO, OPTS, BLOCK>(s, p, entry_options<OPTS>(p), p.bounce, act, r,
                                           bounce_key<L>(s, l, p.bounce), f, trips, cyc);
  if (act) store_lane(s, lane, r, r.alive);
  tock<COUNT>(cyc, CYC_SHADE, c_all);
}

// Bounces [p.bounce, stop) of each listed lane, until it dies; the warp
// goes on while any of its lanes lives (the marches need the full warp),
// a dead lane's thread with act false.
template <int L, bool RATIO, int OPTS>
__global__ void __launch_bounds__(WINDOW_BLOCK)
    bounce_window_kernel(BounceState s, EntryParams<OPTS> p, int stop) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (warp_past_list(s, t)) return;
  const int lane = list_lane(s, t);
  const int l = lane >= 0 ? lane : 0;  // a thread with no lane reads lane 0 and writes nothing
  LaneRegs<L> r;
  r.pos = load3(s.pos, l);
  r.dir = load3(s.dir, l);
  r.miss0 = false;
  r.alive = lane >= 0;
  load_spectral(s, l, r);
  const Key key = load_key(s.keys, l);
  bool wc_set = false;
  for (int b = p.bounce; b < stop && __any_sync(MARCH_FULL_WARP, r.alive); ++b) {
    const Key kb = fold(key, (uint32_t)b);
    const bool act = r.alive;
    const Flight f = flight_lane<false, OPTS>(s, p, entry_options<OPTS>(p), b, act, r.pos, r.dir,
                                              r.wl[0], kb, nullptr, nullptr);
    shade_lane<false, L, RATIO, OPTS, false>(s, p, entry_options<OPTS>(p), b, act, r, kb, f,
                                             nullptr, nullptr);
    wc_set = wc_set || r.alive;
  }
  if (lane >= 0) store_lane(s, lane, r, wc_set);
}

static int grid_of(int m, int block) { return (m + block - 1) / block; }

enum { ENTRY_FLIGHT, ENTRY_SHADE, ENTRY_WINDOW };

// Launch one entry of the (L, RATIO) instances, or with OPTS their options
// instances, on the list s (m > 0): bounce_flight (its outcome into scratch;
// RATIO false only, the flight does not depend on it), bounce_shade (from
// scratch), each as its census instance where s.trips is set, or
// bounce_window (bounces [p.bounce, stop)). Each (L, RATIO, OPTS) set is
// instantiated in one source (the header's comment names them); the others
// declare it extern below.
template <int L, bool RATIO, int OPTS>
int launch_entry(int entry, const BounceState& s, const BounceParams& bp,
                 const BounceOptionsFloors& o, void* scratch, int stop, cudaStream_t stream) {
  EntryParams<OPTS> p;
  static_cast<BounceParams&>(p) = bp;
  if constexpr (OPTS == INST_OPTIONS) p.o = static_cast<const BounceOptions&>(o);
  if constexpr (OPTS == INST_ESTIMATOR) p.o = static_cast<const BounceOptionsEst&>(o);
  if constexpr (OPTS == INST_FLOORS) p.o = o;
  if (entry == ENTRY_FLIGHT) {
    if constexpr (RATIO) {
      return (int)cudaErrorInvalidValue;
    } else {
      float4* out = static_cast<float4*>(scratch);
      if (s.trips) {
        bounce_flight_kernel<L, true, OPTS>
            <<<grid_of(s.m, BOUNCE_BLOCK), BOUNCE_BLOCK, 0, stream>>>(s, p, out);
      } else {
        bounce_flight_kernel<L, false, OPTS>
            <<<grid_of(s.m, BOUNCE_BLOCK), BOUNCE_BLOCK, 0, stream>>>(s, p, out);
      }
    }
  } else if (entry == ENTRY_SHADE) {
    const float4* in = static_cast<const float4*>(scratch);
    if constexpr (OPTS != INST_DEFAULT) {
      if (naive_block_on(o)) {  // the naive shadow march block-cooperative
        const size_t smem = naive_march_smem<BOUNCE_BLOCK>();
        if (s.trips) {
          bounce_shade_kernel<L, true, RATIO, OPTS, true>
              <<<grid_of(s.m, BOUNCE_BLOCK), BOUNCE_BLOCK, smem, stream>>>(s, p, in);
        } else {
          bounce_shade_kernel<L, false, RATIO, OPTS, true>
              <<<grid_of(s.m, BOUNCE_BLOCK), BOUNCE_BLOCK, smem, stream>>>(s, p, in);
        }
        return (int)cudaGetLastError();
      }
    }
    if (s.trips) {
      bounce_shade_kernel<L, true, RATIO, OPTS>
          <<<grid_of(s.m, BOUNCE_BLOCK), BOUNCE_BLOCK, 0, stream>>>(s, p, in);
    } else {
      bounce_shade_kernel<L, false, RATIO, OPTS>
          <<<grid_of(s.m, BOUNCE_BLOCK), BOUNCE_BLOCK, 0, stream>>>(s, p, in);
    }
  } else {
    bounce_window_kernel<L, RATIO, OPTS><<<grid_of(s.m, WINDOW_BLOCK), WINDOW_BLOCK, 0, stream>>>(
        s, p, stop);
  }
  return (int)cudaGetLastError();
}

// Occupancy of an entry (which: 0 bounce_flight, 1 bounce_shade, 2
// bounce_window) at L (4 in the main library, a width library's own width)
// and the closed form, the default instance or the options instance
// (OPTS), on the current device: out = (resident blocks per SM, threads per
// block, registers per thread, local memory bytes per thread). Instantiated
// with that set (bounce.cu, bounce_opts.cu, width/bounce_default.cu,
// width/bounce_floor.cu).
template <int OPTS, int L = 4>
int entry_occupancy(int which, int* out) {
  const void* fns[] = {
      (const void*)bounce_flight_kernel<L, false, OPTS>,
      (const void*)bounce_shade_kernel<L, false, false, OPTS>,
      (const void*)bounce_window_kernel<L, false, OPTS>,
  };
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  const int block = which == 2 ? WINDOW_BLOCK : BOUNCE_BLOCK;
  int blocks = 0;
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[which], block, 0);
  if (rc != cudaSuccess) return (int)rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, fns[which]);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = blocks;
  out[1] = block;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
extern template int entry_occupancy<INST_DEFAULT>(int, int*);
extern template int entry_occupancy<INST_OPTIONS>(int, int*);
extern template int entry_occupancy<INST_ESTIMATOR>(int, int*);
extern template int entry_occupancy<INST_FLOORS>(int, int*);

#define DE_BOUNCE_INSTANCE(L, RATIO, OPTS)                                               \
  template int launch_entry<L, RATIO, OPTS>(int, const BounceState&, const BounceParams&, \
                                            const BounceOptionsFloors&, void*, int, cudaStream_t)
extern DE_BOUNCE_INSTANCE(4, false, INST_DEFAULT);
extern DE_BOUNCE_INSTANCE(1, false, INST_DEFAULT);
extern DE_BOUNCE_INSTANCE(4, true, INST_DEFAULT);
extern DE_BOUNCE_INSTANCE(1, true, INST_DEFAULT);
extern DE_BOUNCE_INSTANCE(4, false, INST_OPTIONS);
extern DE_BOUNCE_INSTANCE(1, false, INST_OPTIONS);
extern DE_BOUNCE_INSTANCE(4, true, INST_OPTIONS);
extern DE_BOUNCE_INSTANCE(1, true, INST_OPTIONS);
extern DE_BOUNCE_INSTANCE(4, false, INST_ESTIMATOR);
extern DE_BOUNCE_INSTANCE(1, false, INST_ESTIMATOR);
extern DE_BOUNCE_INSTANCE(4, true, INST_ESTIMATOR);
extern DE_BOUNCE_INSTANCE(1, true, INST_ESTIMATOR);
extern DE_BOUNCE_INSTANCE(4, false, INST_FLOORS);
extern DE_BOUNCE_INSTANCE(1, false, INST_FLOORS);
extern DE_BOUNCE_INSTANCE(4, true, INST_FLOORS);
extern DE_BOUNCE_INSTANCE(1, true, INST_FLOORS);

}  // namespace de
