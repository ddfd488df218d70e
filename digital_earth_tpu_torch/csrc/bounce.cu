// The bounce entries' C interface and their default instances: a packet of
// L = 4 wavelengths, the gases' sun transmittance in closed form. The
// device code and the launchers are in bounce.cuh, which says what the
// entries compute, what bounds them on the H100 and how they are built: the
// other instances are in bounce_l1.cu, bounce_ratio.cu and
// bounce_l1_ratio.cu, the options instances in their *_opts.cu twins, the
// estimator instances in their *_est.cu twins and the floor instances in
// their *_floor.cu twins. A launch takes the instance its parameters ask
// for (ip[0], ip[15], ip[33]). Built with -DDE_WIDTH=L, these are a width
// library's entries (packet_width.cuh): at that width alone, the default
// instances of width/bounce_default.cu and width/bounce_ratio_default.cu and
// the floor instances of width/bounce_floor.cu and width/bounce_ratio_floor.cu.
#include "bounce.cuh"
#include "packet_width.cuh"

namespace de {

#ifdef DE_WIDTH
extern DE_BOUNCE_INSTANCE(DE_WIDTH, false, INST_DEFAULT);
extern DE_BOUNCE_INSTANCE(DE_WIDTH, true, INST_DEFAULT);
extern DE_BOUNCE_INSTANCE(DE_WIDTH, false, INST_FLOORS);
extern DE_BOUNCE_INSTANCE(DE_WIDTH, true, INST_FLOORS);
extern template int entry_occupancy<INST_DEFAULT, DE_WIDTH>(int, int*);
extern template int entry_occupancy<INST_FLOORS, DE_WIDTH>(int, int*);
#else
DE_BOUNCE_INSTANCE(4, false, INST_DEFAULT);
template int entry_occupancy<INST_DEFAULT>(int, int*);
#endif

static bool is_flag(int v) { return v == 0 || v == 1; }

// The parameters, the options and the instance that runs (INST_*).
static int unpack_params(const float* fp, const int* ip, BounceParams& p,
                         BounceOptionsFloors& o, int& opts) {
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
  for (int j = 0; j < 3; ++j) p.max_dens[j] = fp[13 + j];
  p.n_lambdas = ip[0];
  if (!holds_width(p.n_lambdas)) return (int)cudaErrorInvalidValue;
  p.bounce = ip[1];
  p.rr_start = ip[2];
  p.march_steps = ip[3];
  p.march_k = ip[4];
  if (p.march_k < 1 || 32 % p.march_k != 0) return (int)cudaErrorInvalidValue;
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
  p.ratio = ip[15];
  if (!is_flag(p.ratio)) return (int)cudaErrorInvalidValue;
  o.enable_clouds = ip[16];
  o.mo = MarchOpts{ip[17], ip[18], ip[20], ip[21]};
  o.lazy_march = ip[19];
  o.naive_tracking = ip[22];
  o.naive_march = ip[23];
  o.naive_cloud_tracking = ip[24];
  o.naive_shadow = ip[25];
  o.analytic_flight = ip[26];
  o.newton_iters = ip[27];
  o.fast_loop_rng = ip[28];
  o.nee_rr_start = ip[29];
  o.cloud_rr_start = ip[30];
  o.nee_off = ip[31];
  o.nee_rr_prob = fp[16];
  o.nee_w = fp[17];
  o.cloud_rr_keep = fp[18];
  o.cloud_w = fp[19];
  o.cert = ip[32];
  o.floor_first = fp[20];
  o.stall_first = fp[21];
  o.floor_past = fp[22];
  o.stall_past = fp[23];
  o.floor_uncert = fp[24];
  opts = ip[33];
  static const int flag_slots[] = {16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 28, 31, 32};
  for (int j : flag_slots) {
    if (!is_flag(ip[j])) return (int)cudaErrorInvalidValue;
  }
  if (opts < INST_DEFAULT || opts > INST_FLOORS || o.newton_iters < 0 ||
      !(o.nee_rr_prob > 0.0f && o.nee_rr_prob <= 1.0f) ||
      !(o.cloud_rr_keep > 0.0f && o.cloud_rr_keep <= 1.0f) || !(o.floor_first > 0.0f) ||
      !(o.stall_first > 0.0f) || !(o.floor_past > 0.0f) || !(o.stall_past > 0.0f) ||
      !(o.floor_uncert > 0.0f)) {
    return (int)cudaErrorInvalidValue;
  }
  // the default instances run the options' defaults only, the options
  // instances the estimator options' defaults only (the roulettes' start
  // bounces and the Newton steps act only with their options), the
  // estimator instances the march floors' defaults only
  const bool defaults = o.enable_clouds == 1 && o.mo.enable == 1 && o.mo.bilinear == 0 &&
                        o.lazy_march == 1 && o.mo.exact_ocean == 1 && o.mo.ref_phantom == 1 &&
                        o.naive_tracking == 0 && o.naive_march == 0 &&
                        o.naive_cloud_tracking == 0 && o.naive_shadow == 0;
  const bool est_defaults = o.analytic_flight == 0 && o.fast_loop_rng == 0 && o.nee_off == 0 &&
                            o.nee_rr_prob == 1.0f && o.cloud_rr_keep == 1.0f;
  // (the march floors at their defaults: no certified floor, the primary
  // marches' floor and stall threshold the shadow march's at every bounce)
  const bool floor_defaults = o.cert == 0 && o.floor_first == p.step_floor &&
                              o.floor_past == p.step_floor && o.stall_first == p.stall_thresh &&
                              o.stall_past == p.stall_thresh;
  if ((opts == INST_DEFAULT && !defaults) || (opts < INST_ESTIMATOR && !est_defaults) ||
      (opts < INST_FLOORS && !floor_defaults)) {
    return (int)cudaErrorInvalidValue;
  }
  // the naive trackers are single-wavelength
  if (o.naive_tracking && p.n_lambdas != 1) return (int)cudaErrorInvalidValue;
  return 0;
}

// Launch an entry at the width and transmittance the parameters ask for,
// its options or estimator instance where they ask for it.
template <int OPTS>
static int launch_bounce(int entry, const BounceState& s, const BounceParams& p,
                         const BounceOptionsFloors& o, void* scratch, int stop,
                         cudaStream_t stream) {
  return with_width(p.n_lambdas, [&](auto width) {
    constexpr int L = decltype(width)::value;
    return p.ratio ? launch_entry<L, true, OPTS>(entry, s, p, o, scratch, stop, stream)
                   : launch_entry<L, false, OPTS>(entry, s, p, o, scratch, stop, stream);
  });
}

static int launch_bounce(int entry, const BounceState& s, const BounceParams& p,
                         const BounceOptionsFloors& o, int opts, void* scratch, int stop,
                         cudaStream_t stream) {
#ifdef DE_WIDTH
  // a width library holds the default instances and the floor instances,
  // which read every option and so run every other instance's settings
  return opts == INST_DEFAULT ? launch_bounce<INST_DEFAULT>(entry, s, p, o, scratch, stop, stream)
                              : launch_bounce<INST_FLOORS>(entry, s, p, o, scratch, stop, stream);
#else
  if (opts == INST_FLOORS) {
    return launch_bounce<INST_FLOORS>(entry, s, p, o, scratch, stop, stream);
  }
  if (opts == INST_ESTIMATOR) {
    return launch_bounce<INST_ESTIMATOR>(entry, s, p, o, scratch, stop, stream);
  }
  return opts ? launch_bounce<INST_OPTIONS>(entry, s, p, o, scratch, stop, stream)
              : launch_bounce<INST_DEFAULT>(entry, s, p, o, scratch, stop, stream);
#endif
}

}  // namespace de

// fp (25 floats): scale, step_floor, stall_thresh (the shadow march's, and
//     at the march floors' defaults every march's), o3_env_peak,
//     light_direction[3], sun_cos_angle, solid_angle (of the sun's cone),
//     offset_scale (1 + 1e-4 scale / 12000), planck_a, planck_b, planck_k,
//     the gases' majorant densities[3] (read with ratio tracking); the
//     estimator options nee_rr_prob, float32(1 / nee_rr_prob), cloud_rr_keep,
//     float32(1 / cloud_rr_keep) (each in (0, 1], the reciprocals of the
//     Python floats); the march floors: the primary marches' step floor and
//     stall threshold at bounce 0, then past it, and the uncertified floor
//     (each above 0)
// ip (34 ints): n_lambdas (L: 1 or 4; a width library's own), bounce, rr_start, land_march_steps,
//     march_k, march_patience, max_tracking_steps, tracking_k,
//     bilinear_materials, topography H, W, material H, W, clouds H, W,
//     ratio (1: the gases' sun transmittance by ratio tracking, the
//     reference's estimator; 0: the closed form); the scene and march
//     options enable_clouds, enable_land, bilinear_tracking, lazy_march,
//     march_exact_ocean, march_ref_phantom, and the naive arm's
//     naive_tracking (L = 1 only), naive_march, naive_cloud_tracking,
//     naive_shadow (each 0 or 1); the estimator options analytic_flight,
//     flight_newton_iters, fast_loop_rng, nee_rr_start, cloud_rr_start,
//     nee_off; the certified floor march_certified_floor (0 or 1); the
//     instance (3: the floor instance; 2: the estimator instance, which takes
//     the march floors' defaults only; 1: the options instance, which
//     takes the estimator options' and the march floors' defaults only; 0: the
//     default, which takes every option's default only; every instance takes
//     any march_patience, and the roulettes' start bounces and the Newton
//     steps, which act only with their options; a width library holds 0 and
//     3, and runs 1 and 2 as 3)
// State (n lanes, read and written in place at the lanes of idx): pos,
// dir (N, 3); wavelength, lambda_pdf, throughput, radiance, w_mis (N, L);
// alive, primary_miss (N,) bool; work_class (N,) int32; keys (N, 2) int32.
// idx holds m entries (an upper bound of the live count); n_live, when not
// null, is the live count on the device (entries at or past it are skipped).
// Tables: topography (H, W, 4), material (H, W, 8), clouds (H, W, 4) uint8;
// o3_crossec (441,), srgb2spec (300, 3), density table (384, 1024, 3) f32.
// trips (bounce_flight, bounce_shade): null, or (m, 7) int32 trip counts
// (the census instances); cycles: null, or with trips (m, 9) int64 clock64
// cycles (SITE_* columns, then the flight's and the shade's whole).
#define DE_BOUNCE_ARGS                                                                    \
  const float *fp, const int *ip, float *pos, float *dir, const float *wavelength,        \
      const float *lambda_pdf, float *throughput, float *radiance, float *w_mis,          \
      bool *alive, bool *primary_miss, int32_t *work_class, const int32_t *keys,          \
      const int32_t *idx, const int32_t *n_live, int m, int n, const uint8_t *topo,       \
      const uint8_t *material, const uint8_t *clouds, const float *o3,                    \
      const float *srgb2spec, const float *table
#define DE_BOUNCE_STATE(trips, cycles)                                                    \
  de::BounceState {                                                                       \
    pos, dir, wavelength, lambda_pdf, throughput, radiance, w_mis, alive, primary_miss,   \
        work_class, keys, idx, n_live, topo, material, clouds, o3, srgb2spec, table,      \
        trips, cycles, m, n                                                               \
  }

// bounce_flight: the flight's outcome of each list entry into scratch (m,
// float4); trips and cycles as DE_BOUNCE_ARGS documents (sites 0-3 and
// the flight's whole written).
extern "C" int de_bounce_flight(DE_BOUNCE_ARGS, void* scratch, int32_t* trips, long long* cycles,
                                void* stream) {
  de::BounceParams p;
  de::BounceOptionsFloors o;
  int opts;
  if (int rc = de::unpack_params(fp, ip, p, o, opts)) return rc;
  if (m <= 0) return (int)cudaGetLastError();
  p.ratio = 0;  // the flight does not depend on it: one instance per width
  return de::launch_bounce(de::ENTRY_FLIGHT, DE_BOUNCE_STATE(trips, cycles), p, o, opts, scratch,
                           0, (cudaStream_t)stream);
}

// bounce_shade: steps 4-7 from bounce_flight's scratch (m, float4); trips
// and cycles (sites 4-6 and the shade's whole written).
extern "C" int de_bounce_shade(DE_BOUNCE_ARGS, const void* scratch, int32_t* trips,
                               long long* cycles, void* stream) {
  de::BounceParams p;
  de::BounceOptionsFloors o;
  int opts;
  if (int rc = de::unpack_params(fp, ip, p, o, opts)) return rc;
  if (m <= 0) return (int)cudaGetLastError();
  return de::launch_bounce(de::ENTRY_SHADE, DE_BOUNCE_STATE(trips, cycles), p, o, opts,
                           const_cast<void*>(scratch), 0, (cudaStream_t)stream);
}

// Bounces [ip[1], stop) of the listed lanes in one launch.
extern "C" int de_bounce_window(DE_BOUNCE_ARGS, int stop, void* stream) {
  de::BounceParams p;
  de::BounceOptionsFloors o;
  int opts;
  if (int rc = de::unpack_params(fp, ip, p, o, opts)) return rc;
  if (m <= 0 || stop <= p.bounce) return (int)cudaGetLastError();
  return de::launch_bounce(de::ENTRY_WINDOW, DE_BOUNCE_STATE(nullptr, nullptr), p, o, opts,
                           nullptr, stop, (cudaStream_t)stream);
}

// Occupancy of an entry on the current device: out = (resident blocks per
// SM, threads per block, registers per thread, local memory bytes per
// thread). which: 0 bounce_flight, 1 bounce_shade, 2 bounce_window, each
// at L = 4 and the closed-form transmittance: the default instance (opts 0),
// the options instance (1, bounce_opts.cu), the estimator instance (2,
// bounce_est.cu) or the floor instance (3, bounce_floor.cu); in a width
// library, its default (0) or floor instance (3) at its width.
extern "C" int de_bounce_occupancy(int which, int opts, int* out) {
#ifdef DE_WIDTH
  switch (opts) {
    case de::INST_DEFAULT: return de::entry_occupancy<de::INST_DEFAULT, DE_WIDTH>(which, out);
    case de::INST_FLOORS: return de::entry_occupancy<de::INST_FLOORS, DE_WIDTH>(which, out);
    default: return (int)cudaErrorInvalidValue;
  }
#else
  switch (opts) {
    case de::INST_DEFAULT: return de::entry_occupancy<de::INST_DEFAULT>(which, out);
    case de::INST_OPTIONS: return de::entry_occupancy<de::INST_OPTIONS>(which, out);
    case de::INST_ESTIMATOR: return de::entry_occupancy<de::INST_ESTIMATOR>(which, out);
    case de::INST_FLOORS: return de::entry_occupancy<de::INST_FLOORS>(which, out);
    default: return (int)cudaErrorInvalidValue;
  }
#endif
}
