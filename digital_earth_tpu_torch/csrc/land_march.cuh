// The displaced-sphere land march with the reference's phantom crawl, as
// one warp-cooperative device function, land_march_warp: the body of the
// land_march kernel (land_march.cu), of the bounce entries' three march
// calls (bounce.cu) and of the preview kernel's land and shadow marches
// (preview.cu).
//
// Per lane it computes what the TPU loop digital_earth_tpu/render/
// pathtracer.py:211 intersect_land (masked lax.while_loop at :301-333, K
// probes per iteration) and :515 _phantom_crawl compute: bounding-sphere cull
// and bracket, K probes at the lane's stride, the three regional max-mip
// skips (25/115/8 km), the texel-arc step floor, negative-SDF backtrack, the
// exact ocean root, stall termination, the t_cap, the any-hit mode and the
// probe budget; probes after the first stopping one do not change the
// result, so the sweep stops there.
//
// OPTS (a template parameter): the options instance, which reads the
// march's options from MarchOpts at run time (TraceConfig.enable_land,
// bilinear_tracking, march_exact_ocean, march_ref_phantom; the stall
// patience is MarchParams::patience in both). OPTS false compiles them in at
// their defaults (land, nearest taps, the ocean root, the phantom crawl), the
// code of the default instances.
//
// CERT (a template parameter beside OPTS): the certified floor
// (TraceConfig.march_certified_floor, pathtracer.py:381-405). A probe whose
// hop [ts, ts + step_floor] provably clears one of the three regional bound
// spheres whose validity radius exceeds the floor (the ray's least radius
// over the hop from the shared quadratic) steps by the floor; any other by
// ``uncert`` (march_uncert_floor_frac of a texel arc), which is also the
// stride's floor. The host passes the stall threshold as a quarter of
// ``uncert`` and keeps step_floor the initial stride. CERT false compiles
// none of it: the default and options instances keep their code. Each probe
// is certified on the thread that takes it.
#pragma once
#include <cstdint>

#include "atmosphere.cuh"
#include "texture.cuh"

namespace de {

struct MarchParams {
  int H, W;
  float scale, step_floor, stall_thresh;
  int steps, k, patience, any_hit;
};

// The march's options, read by the options instance (OPTS) only.
struct MarchOpts {
  int enable, bilinear, exact_ocean, ref_phantom;
};

// The march's bracket: the bounding-sphere cull, the start and the miss
// distance (capped at cap).
struct MarchSpan {
  float t0, miss_beyond;
  bool may_hit;
};

__device__ __forceinline__ MarchSpan march_span(const MarchParams& p, V3 o, V3 d, bool act,
                                                float cap) {
  float bound_near, bound_far;
  rsi(o, d, PLANET_R_F + p.scale, bound_near, bound_far);
  MarchSpan sp;
  sp.t0 = fmaxf(bound_near, 0.0f);
  sp.miss_beyond = fminf(fminf(bound_far + 1.0f, MAX_RAY_DIST_F), cap);
  sp.may_hit = act && (bound_far > 0.0f) && (sp.t0 < cap);
  return sp;
}

// One probe at ts = t + j stride: the regional skip, the step, and whether
// it stops the iteration (converged, out of the bracket, or a step below the
// stride). t_stop is the converged distance, else ts.
struct Probe {
  float t_stop, step;
  bool stop, conv, out;
};

// OPTS: the options ``mo``: bilinear taps (the twin's sample_sphere_texture
// as it rounds on the card, texture.cuh sphere_tap) where mo->bilinear, the
// ocean root only where mo->exact_ocean. CERT: the certified floor, with
// ``uncert`` the uncertified floor.
template <bool OPTS = false, bool CERT = false>
__device__ __forceinline__ Probe march_probe(const uint8_t* __restrict__ topo,
                                             const MarchParams& p, V3 o, V3 d, float ts,
                                             float stride, float miss_beyond,
                                             const MarchOpts* mo = nullptr, float uncert = 0.0f) {
  const float valid3[3] = {25e3f, 115e3f, 8e3f};
  const V3 ro = along(o, ts, d);
  float s[4];
  if constexpr (OPTS) {
    if (mo->bilinear) sphere_tap<4>(topo, p.H, p.W, ro, true, s);
    else sphere_tap_nearest<4>(topo, p.H, p.W, ro, s);
  } else {
    sphere_tap_nearest<4>(topo, p.H, p.W, ro, s);
  }
  const float b = dot(ro, d);
  const V3 cr = cross(ro, d);
  const float h2b = dot(cr, cr);
  const float rlen = sqrtf(dot(ro, ro));
  const float f = (rlen - PLANET_R_F) - p.scale * s[0];

  const float pdisc = PLANET_R_F * PLANET_R_F - h2b;
  const float p_near = pdisc < 0.0f ? -1.0f : -b - sqrtf(fmaxf(pdisc, 0.0f));
  float s_region = 0.0f;
  bool ocean_hit = false;
  // CERT: the hop's least squared radius: at its start while ascending, at
  // its end while descending throughout, the perigee's otherwise
  float min_r2 = 0.0f;
  bool cert = false;
  if constexpr (CERT) {
    const float b_end = b + p.step_floor;
    min_r2 = h2b + (b >= 0.0f ? b * b : (b_end <= 0.0f ? b_end * b_end : 0.0f));
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float mip = s[1 + m];
    const float r_bound = PLANET_R_F + p.scale * mip;
    const float disc = r_bound * r_bound - h2b;
    const float sqd = sqrtf(fmaxf(disc, 0.0f));
    const bool miss = disc < 0.0f;
    const float near_ = miss ? -1.0f : -b - sqd;
    const float far_ = miss ? -1.0f : -b + sqd;
    const float skip = near_ > 0.0f ? fminf(near_, valid3[m])
                     : (far_ < 0.0f ? valid3[m] : 0.0f);
    s_region = m == 0 ? skip : fmaxf(s_region, skip);
    ocean_hit = ocean_hit || ((mip <= 0.0f) && (p_near > 0.0f) && (p_near <= valid3[m]));
    if constexpr (CERT) {
      cert = cert || ((min_r2 > r_bound * r_bound) && (p.step_floor < valid3[m]));
    }
  }
  if constexpr (OPTS) {
    if (!mo->exact_ocean) ocean_hit = false;
  }
  Probe q;
  if constexpr (CERT) {
    q.step = f < 0.0f ? f : fmaxf(fmaxf(f, s_region), cert ? p.step_floor : uncert);
  } else {
    q.step = f < 0.0f ? f : fmaxf(fmaxf(f, s_region), p.step_floor);
  }
  bool converged = fabsf(f) < ts * 1e-4f;
  float t_conv = converged ? ts : ts + p_near;
  converged = converged || ocean_hit;
  if (p.any_hit && f < 0.0f) {
    converged = true;
    t_conv = ts;
  }
  q.out = ts > miss_beyond;
  q.conv = converged;
  q.t_stop = converged ? t_conv : ts;
  q.stop = converged || q.out || q.step < stride;
  return q;
}

// The march's state between iterations.
struct MarchState {
  float t, stride;
  int stall, it;
  bool done, missed;
};

// One iteration's update from q, its first stopping probe (any_stop), else
// its last probe; the stride's floor is ``stride_floor``.
__device__ __forceinline__ void march_advance(MarchState& m, const MarchParams& p, bool any_stop,
                                              const Probe& q, float stride_floor) {
  const float t_new = (any_stop && (q.conv || q.out)) ? q.t_stop : q.t_stop + q.step;
  const float stride_new = fmaxf(q.step, stride_floor);
  const bool newly_done = any_stop && (q.conv || q.out);
  if (any_stop && q.out && !q.conv) m.missed = true;
  const float t_next = newly_done ? q.t_stop : t_new;
  const bool stalled_now = !newly_done && (t_next - m.t < p.stall_thresh);
  m.stall = stalled_now ? m.stall + 1 : 0;
  const bool stuck = m.stall >= p.patience;
  if (!(newly_done || stuck)) m.stride = stride_new;
  m.done = newly_done || stuck;
  m.t = t_next;
}

// The reference's phantom crawl for an active lane whose march missed (a
// serial chain): the hit distance, or result unchanged.
__device__ __forceinline__ float phantom_crawl(const MarchParams& p, V3 o, V3 d, bool act,
                                               float cap, float result) {
  const float b0 = dot(o, d);
  const V3 cr = cross(o, d);
  const float h2 = dot(cr, cr);
  float a_near, a_far;
  rsi(o, d, ATMOS_UPPER_F, a_near, a_far);
  const float perigee_alt = sqrtf(h2) - PLANET_R_F;
  if (act && result < 0.0f && perigee_alt < 16e3f) {
    float tp = a_near > 0.0f ? a_near : 0.0f;
    bool pdone = false;
    for (int i = 0; i < p.steps && !pdone; i += 8) {
      for (int s = 0; s < 8 && !pdone; ++s) {
        const float bb = b0 + tp;
        const float dist = sqrtf(h2 + bb * bb) - PLANET_R_F;
        const float t_new = tp + dist;
        pdone = (t_new > MAX_RAY_DIST_F) || (fabsf(dist) < t_new * 1e-4f);
        tp = t_new;
      }
    }
    if (tp < MAX_RAY_DIST_F && tp < cap) result = tp;
  }
  return result;
}

constexpr unsigned MARCH_FULL_WARP = 0xffffffffu;

// Hit distance along o + t d, -1 on a miss; an inactive lane misses (and
// with OPTS every lane where the options ``mo`` say no land, with no
// trips; without the phantom crawl where they say so). With
// ``iters`` the march's iterations (K probes each; the phantom crawl's not
// counted) are written there, as the plain twin's masked loop counts them.
// Every thread of the warp must call it (it shuffles across the full warp),
// active or not; each returns its own lane's result (and iteration count),
// bit for bit what one thread running its lane's K probes in turn gives.
// K = p.k must divide 32 (the host checks it).
//
// An iteration's K probes depend only on the iteration's t and stride
// (ts = t + j stride), and the iteration ends at the first probe that
// stops. So the warp ballots its lanes that pass the bounding-sphere cull
// and spreads each lane's probes over T threads, T the most that its c
// marching lanes leave (K for c <= 32 / K, down to 1 for c > 16): thread s
// of a lane's group evaluates probes s K/T ... (s + 1) K/T - 1 in order,
// stopping at its first stopping probe; the group's ballot finds its first
// thread with a stop (or none), and that probe's t_stop, step and flags
// (or the last probe's) come to every thread of the group by a shuffle,
// which then applies the iteration's update identically. The same
// operations on the same operands: a lane's chain shortens from its probes
// to its iterations where the warp has threads to spare, and a warp of
// marching lanes only runs one thread per lane as before. The phantom
// crawl, a serial chain, stays with the lane's own thread. CERT: the
// certified floor, ``uncert`` the uncertified floor (the header's comment).
template <bool OPTS = false, bool CERT = false>
__device__ __forceinline__ float land_march_warp(const uint8_t* __restrict__ topo,
                                                 const MarchParams& p, V3 o, V3 d, bool act,
                                                 float cap, int* iters = nullptr,
                                                 const MarchOpts* mo = nullptr,
                                                 float uncert = 0.0f) {
  if constexpr (OPTS) {
    if (!mo->enable) {  // uniform over the launch
      if (iters) *iters = 0;
      return -1.0f;
    }
  }
  const MarchSpan sp = march_span(p, o, d, act, cap);
  const unsigned marching = __ballot_sync(MARCH_FULL_WARP, sp.may_hit);
  float t_out = sp.t0;
  bool missed_out = !sp.may_hit;
  int it_out = 0;
  if (marching) {  // warp-uniform
    const int c = __popc(marching);
    int T = p.k;  // threads per lane, warp-uniform
    while (T > 1 && c * T > 32) T >>= 1;
    const int per = p.k / T;  // probes per thread
    const int lane = threadIdx.x & 31, grp = lane / T, sub = lane % T;
    const unsigned gmask = (T == 32 ? MARCH_FULL_WARP : (1u << T) - 1u) << (grp * T);
    // group g marches the g-th marching lane; a lane's result comes back
    // from its group's first thread
    unsigned rest = marching;  // without its grp lowest lanes
    for (int g = 0; g < grp && rest; ++g) rest &= rest - 1u;
    const int owner = grp < c ? __ffs(rest) - 1 : -1;
    const int mine = sp.may_hit ? __popc(marching & ((1u << lane) - 1u)) : -1;
    const int src = owner >= 0 ? owner : lane;
    const V3 so{__shfl_sync(MARCH_FULL_WARP, o.x, src), __shfl_sync(MARCH_FULL_WARP, o.y, src),
                __shfl_sync(MARCH_FULL_WARP, o.z, src)};
    const V3 sd{__shfl_sync(MARCH_FULL_WARP, d.x, src), __shfl_sync(MARCH_FULL_WARP, d.y, src),
                __shfl_sync(MARCH_FULL_WARP, d.z, src)};
    const float miss_beyond = __shfl_sync(MARCH_FULL_WARP, sp.miss_beyond, src);
    MarchState m{__shfl_sync(MARCH_FULL_WARP, sp.t0, src), p.step_floor, 0, 0, owner < 0, false};
    for (int i = 0; i < p.steps && __any_sync(MARCH_FULL_WARP, !m.done); i += p.k) {
      Probe q{0.0f, 0.0f, false, false, false};
      if (!m.done) {
        for (int j = sub * per; j < (sub + 1) * per; ++j) {
          q = march_probe<OPTS, CERT>(topo, p, so, sd, m.t + (float)j * m.stride, m.stride,
                                      miss_beyond, mo, uncert);
          if (q.stop) break;
        }
      }
      Probe first = q;  // T = 1: the thread's own
      if (T > 1) {  // warp-uniform
        const unsigned stops = __ballot_sync(MARCH_FULL_WARP, q.stop) & gmask;
        const int from = stops ? __ffs(stops) - 1 : grp * T + T - 1;
        first.t_stop = __shfl_sync(MARCH_FULL_WARP, q.t_stop, from);
        first.step = __shfl_sync(MARCH_FULL_WARP, q.step, from);
        const int flags = __shfl_sync(MARCH_FULL_WARP, (int)q.conv | ((int)q.out << 1), from);
        first.conv = flags & 1;
        first.out = (flags >> 1) & 1;
        first.stop = stops != 0;
      }
      if (!m.done) {
        ++m.it;
        march_advance(m, p, first.stop, first, CERT ? uncert : p.step_floor);
      }
    }
    const int back = mine >= 0 ? mine * T : lane;
    const float r_t = __shfl_sync(MARCH_FULL_WARP, m.t, back);
    const int r_missed = __shfl_sync(MARCH_FULL_WARP, (int)m.missed, back);
    const int r_it = __shfl_sync(MARCH_FULL_WARP, m.it, back);
    if (mine >= 0) {
      t_out = r_t;
      missed_out = r_missed != 0;
      it_out = r_it;
    }
  }
  if (iters) *iters = it_out;
  if constexpr (OPTS) {
    if (!mo->ref_phantom) return (!missed_out && t_out < MAX_RAY_DIST_F) ? t_out : -1.0f;
  }
  return phantom_crawl(p, o, d, act, cap, (!missed_out && t_out < MAX_RAY_DIST_F) ? t_out : -1.0f);
}

}  // namespace de
