// The reference-faithful naive arm as device functions: the body of the
// naive_march and naive_track launchers (naive_march.cu, naive_track.cu) and
// of the bounce entries' knob instances (options, estimator, floors) under
// TraceConfig.naive_tracking, naive_march, naive_cloud_tracking and
// naive_shadow (bounce.cuh). The march runs block-cooperatively
// (naive_march_block: a block's lanes still marching packed onto its first
// threads between rounds of steps) in the launcher and at the shadow march
// under naive_march and naive_shadow (bounce_shade's BLOCK instances), one
// thread a lane (naive_march_lane) at bounce_flight's marches, at the shadow
// march under naive_tracking and in bounce_window; the trackers run as
// warp-cooperative steps (naive_track_warp, at the end) everywhere.
//
// Replaces the TPU loops of digital_earth_tpu/render/tracking_naive.py:
//   - naive_march_lane / naive_march_block <- :31 intersect_land_naive: an
//     RSI warm start on the atmosphere shell, then up to land_march_steps
//     steps of the signed SDF (length - R - scale h, one tap of the
//     topography's channel 0), stopping at |dist| < 1e-4 of the distance or
//     past ten planet radii; a hit if the distance ends under that cap. No
//     cap, any-hit mode, mips, floor, ocean root, stall patience or phantom
//     crawl;
//   - naive_track_warp <- :72 delta_track_naive: a step at the global
//     majorant from the draws uniform(fold(key, i), (3,)), the species'
//     densities at the step (the gases' analytic profile, or the cloud map's
//     channel 0 and the split shape), the event by u1 < total / majorant, the
//     gas by the cumulative terms at r = u1 * majorant and scatter vs absorb
//     by the albedo table;
//   - naive_track_warp <- :126 ratio_track_naive for the cloud: one draw a
//     step, the transmittance times 1 - total / majorant, a stop past t_max
//     or below 1e-5. For the gases the same loop is rmo_track.cuh's
//     rmo_ratio_lane at one wavelength and one probe an iteration (the same
//     draw, step, density sum and stops, bit for bit), which the launcher
//     and the bounce run.
// Each step rounds as the plain twins in render/tracking_naive.py do on the
// card (a species' total summed left to right; --fmad=false), with draws
// from threefry.cuh bit for bit and taps from texture.cuh (sphere_tap, the
// twin's sample_sphere_texture). A draw the step does not read is not made.
//
// What bounds them on the H100: issue slots lost to divergence and latency.
// A march step is one nearest tap (its length, three IEEE divisions, atan2f,
// asinf and one dependent 4-byte read) and the SDF; a tracker step one
// threefry block per draw and, for the cloud, one tap. A lane's steps are a
// dependent chain of up to land_march_steps (max_tracking_steps for the
// trackers), and a warp runs at its longest lane: one thread a lane, the
// launchers kept 0.36-0.70 of a warp's step slots busy (PERF.md).
// naive_track_warp gives a warp's idle threads the steps of its lanes still
// tracking (a tracker's draws come from its step index alone); a march step
// depends on the last, so naive_march_block moves a block's lanes still
// marching onto as few warps as hold them between rounds of steps, and the
// warps left empty wait at the block's barrier and give their issue slots to
// the SM's other warps.
#pragma once
#include <cstdint>

#include "atmosphere.cuh"
#include "cloud_track.cuh"
#include "texture.cuh"
#include "threefry.cuh"

namespace de {

enum { NAIVE_RMO = 0, NAIVE_CLOUD = 1 };

// The plain march's warm start: the atmosphere shell's near root, or 0.
__device__ __forceinline__ float naive_march_start(V3 o, V3 d) {
  float a_near, a_far;
  rsi(o, d, ATMOS_UPPER_F, a_near, a_far);
  return a_near > 0.0f ? a_near : 0.0f;
}

// One step of the plain march from t: the new distance; ``done`` where it
// stops there (past ten planet radii, or |dist| < 1e-4 of it).
__device__ __forceinline__ float naive_march_step(const uint8_t* __restrict__ topo, int H, int W,
                                                  float scale, bool bilinear, V3 o, V3 d, float t,
                                                  bool& done) {
  const V3 ro = along(o, t, d);
  float s[4];
  sphere_tap<4>(topo, H, W, ro, bilinear, s);
  const float dist = (length(ro) - PLANET_R_F) - scale * s[0];
  const float t_new = t + dist;
  done = (t_new > MAX_RAY_DIST_F) || (fabsf(dist) < t_new * 1e-4f);
  return t_new;
}

// The plain march's hit distance (-1 on a miss or for an inactive lane),
// one thread a lane; ``iters``, if set, gets the lane's steps.
__device__ __forceinline__ float naive_march_lane(const uint8_t* __restrict__ topo, int H, int W,
                                                  float scale, int steps, bool bilinear, V3 o,
                                                  V3 d, bool active, int* iters = nullptr) {
  float t = naive_march_start(o, d);
  bool done = !active;
  int it = 0;
  for (int i = 0; i < steps && !done; ++i) {
    ++it;
    t = naive_march_step(topo, H, W, scale, bilinear, o, d, t, done);
  }
  if (iters) *iters = it;
  return active && t < MAX_RAY_DIST_F ? t : -1.0f;
}

// Steps a lane takes in a round of naive_march_block while more lanes march
// than a warp holds.
constexpr int NAIVE_MARCH_ROUND = 8;

// The dynamic shared memory naive_march_block<NT> takes: the packed lanes'
// rays, distances, steps and owners, each thread's outcome and each warp's
// count.
template <int NT>
constexpr int naive_march_smem() {
  return (11 * NT + NT / 32) * 4;
}

// A barrier of ``count`` threads (a multiple of 32) on named barrier ``id``,
// which the threads of a warp may reach diverged.
__device__ __forceinline__ void naive_bar(int id, int count) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// naive_march_lane's outputs, lane by lane, with the block's NT threads
// (blockDim.x == NT, naive_march_smem<NT>() bytes of dynamic shared memory)
// each bringing its lane: every thread of the block must call it, ``active``
// set where its lane marches. A warp with no marching lane leaves at once;
// the others go on together (a named barrier of theirs). Each round, where
// that leaves one of theirs empty, they pack their lanes still marching, in
// thread order, onto their first threads through shared memory (ray,
// distance, steps and owning thread); then each takes up to
// NAIVE_MARCH_ROUND steps, or every step left once they fit in one warp. A
// lane that stops leaves its distance and steps in its owner's slot; warps
// that hold no lane wait at the barrier and give their issue slots to the
// SM's other warps. A lane's chain is naive_march_step's, step by step, so
// the distance and the steps are the loop's bit for bit.
template <int NT>
__device__ __forceinline__ float naive_march_block(const uint8_t* __restrict__ topo, int H, int W,
                                                   float scale, int steps, bool bilinear, V3 o,
                                                   V3 d, bool active, int* iters = nullptr) {
  static_assert(NT % 32 == 0 && NT <= 1024, "a block of whole warps");
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char naive_march_shared[];
  float* q_ray = reinterpret_cast<float*>(naive_march_shared);  // [7][NT]: o, d, t
  int* q_it = reinterpret_cast<int*>(q_ray + 7 * NT);
  int* q_owner = q_it + NT;
  float* r_t = reinterpret_cast<float*>(q_owner + NT);  // each thread's lane's outcome
  int* r_it = reinterpret_cast<int*>(r_t + NT);
  int* w_live = r_it + NT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float t = naive_march_start(o, d);
  bool live = active && steps > 0;
  {
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) w_live[warp] = __popc(m);
  }
  __syncthreads();
  unsigned part = 0;  // the warps that take part: those with a marching lane
#pragma unroll
  for (int w = 0; w < NW; ++w) part |= (w_live[w] > 0 ? 1u : 0u) << w;
  if (!((part >> warp) & 1u)) {  // no marching lane: no step, the start kept
    if (iters) *iters = 0;
    return active && t < MAX_RAY_DIST_F ? t : -1.0f;
  }
  const int count = 32 * __popc(part);
  const int rank = __popc(part & ((1u << warp) - 1u));  // the warp's place among them
  r_t[tid] = t;  // a lane that takes no step keeps its start
  r_it[tid] = 0;
  int it = 0, owner = tid;
  for (bool first = true;; first = false) {
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0 && !first) w_live[warp] = __popc(m);  // the first round's are posted
    naive_bar(1, count);
    int n = 0, busy = 0, slot = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if ((part >> w) & 1u) {
        const int c = w_live[w];
        slot += w < warp ? c : 0;
        n += c;
        busy += c > 0;
      }
    }
    if (n == 0) break;  // uniform over the warps taking part
    if ((n + 31) / 32 < busy) {  // packing empties a warp
      if (live) {
        slot += __popc(m & ((1u << lane) - 1u));
        q_ray[slot] = o.x;
        q_ray[NT + slot] = o.y;
        q_ray[2 * NT + slot] = o.z;
        q_ray[3 * NT + slot] = d.x;
        q_ray[4 * NT + slot] = d.y;
        q_ray[5 * NT + slot] = d.z;
        q_ray[6 * NT + slot] = t;
        q_it[slot] = it;
        q_owner[slot] = owner;
      }
      naive_bar(1, count);
      const int at = 32 * rank + lane;  // slots in the order of the warps taking part
      live = at < n;
      if (live) {
        o = V3{q_ray[at], q_ray[NT + at], q_ray[2 * NT + at]};
        d = V3{q_ray[3 * NT + at], q_ray[4 * NT + at], q_ray[5 * NT + at]};
        t = q_ray[6 * NT + at];
        it = q_it[at];
        owner = q_owner[at];
      }
    }
    naive_bar(1, count);  // every count and packed lane read before the next round's
    if (live) {
      const int budget = n > 32 ? min(steps, it + NAIVE_MARCH_ROUND) : steps;
      bool done = false;
      while (it < budget && !done) {
        ++it;
        t = naive_march_step(topo, H, W, scale, bilinear, o, d, t, done);
      }
      if (done || it >= steps) {
        r_t[owner] = t;
        r_it[owner] = it;
        live = false;
      }
    }
  }
  naive_bar(1, count);  // every outcome written
  if (iters) *iters = r_it[tid];
  const float t_own = r_t[tid];
  return active && t_own < MAX_RAY_DIST_F ? t_own : -1.0f;
}

// The split-shape slab density (render/tracers.cloud_shape_density) as the
// twin's CUDA ops round it: the height's division by the slab's thickness,
// a Python constant, is a multiply by float32(1 / 6000) (atmosphere.cuh).
__device__ __forceinline__ float naive_shape_density(float tex, float r) {
  const bool in_slab = (r > CLOUDS_LOWER_F) && (r < CLOUDS_UPPER_F);
  const float h = (r - CLOUDS_LOWER_F) * (float)(1.0 / 6000.0);
  const bool shape_on = (h - 0.2f < tex * 0.8f) && (0.2f - h < tex * 0.2f);
  const float density = (in_slab && shape_on) ? fmaxf(tex, 0.4f) : 0.0f;
  return density * CLOUDS_DENSITY_F;
}

// The species' total extinction at p: the gases' e . density (e0, e1, e2
// their extinctions, the terms in c), or the cloud's e0 times the
// split-shape density of one tap.
template <int SPECIES>
__device__ __forceinline__ float naive_total(V3 p, float e0, float e1, float e2,
                                             const uint8_t* __restrict__ clouds, int H, int W,
                                             bool bilinear, float c[3]) {
  if constexpr (SPECIES == NAIVE_RMO) {
    float dens[3];
    get_density(sqrtf(dot(p, p)) - PLANET_R_F, dens);
    c[0] = dens[0] * e0;
    c[1] = dens[1] * e1;
    c[2] = dens[2] * e2;
    return (c[0] + c[1]) + c[2];
  } else {
    float s[4];
    sphere_tap<4>(clouds, H, W, p, bilinear, s);
    return e0 * naive_shape_density(s[0], length(p));
  }
}

// ---------------------------------------------------------------------------
// The trackers as warp-cooperative steps: naive_track_warp, delta tracking of
// either species and the cloud's ratio tracking, the outputs of the
// reference's one-step loops (tracking_naive.py:72, :126) bit for bit, each
// lane's steps counted as the loop counts them.
//
// Step i's draws come from fold(key, i) alone, not from the lane's state. So
// T threads can draw a lane's next T steps, and read their densities, at
// once. Two chains stay serial: the position t_i = t_{i-1} - logf(fmaxf(u0_i,
// 1e-12f)) * inv_max and, for ratio tracking, the transmittance trans_i =
// trans_{i-1} * (1 - total_i * inv_max); each thread computes its own step's
// term, and the group passes the terms along by shuffles in step order, each
// link the loop's own operation on its own operands. Each round:
//   1. the warp ballots its lanes still tracking, c of them, and gives each T
//      threads, the largest power of two with c T <= 32;
//   2. group g takes the g-th tracking lane's state by shuffles (c > 16,
//      T = 1: each lane steps on its own thread, with no shuffle);
//   3. thread s draws step i + s, forms its position from the chain and reads
//      its density; the cloud's tap is skipped where the step's radius lies
//      outside the slab (its density is exactly 0 there), and delta
//      tracking's second draw where total / majorant is not above 0 (u1 <
//      it cannot hold);
//   4. the group's first step in step order past t_max, with an event
//      (delta) or with the transmittance below 1e-5 (ratio) stops the lane
//      there (a ballot within the group); steps drawn past it are dropped;
//   5. the lane's own thread takes the outcome and advances by the steps
//      the loop would have taken, at most max_steps.
// The groups are formed anew each round, so a warp's last tracking lane gets
// all of its threads. Every thread of the warp must call it, ``active`` set
// where its lane tracks; each gets its own lane's outputs.

constexpr unsigned NAIVE_FULL_WARP = 0xffffffffu;

// A warp-cooperative tracker's outputs of the lane: delta tracking's (event,
// t, iid), ratio tracking's transmittance.
struct NaiveTrack {
  int event, iid;
  float t, trans;
};

// Position of the g-th set bit (from 0) of m, which has more than g.
__device__ __forceinline__ int nth_set_bit(unsigned m, int g) {
  int p = 0;
#pragma unroll
  for (int b = 16; b >= 1; b >>= 1) {
    const int c = __popc(m & ((1u << b) - 1u));
    if (g >= c) {
      g -= c;
      m >>= b;
      p += b;
    }
  }
  return p;
}

// naive_total with the cloud's tap skipped where p's radius lies outside the
// slab: naive_shape_density is 0 there whatever the tap, so the total is the
// same bits.
template <int SPECIES>
__device__ __forceinline__ float naive_total_skip(V3 p, float e0, float e1, float e2,
                                                  const uint8_t* __restrict__ clouds, int H,
                                                  int W, bool bilinear, float c[3]) {
  if constexpr (SPECIES == NAIVE_RMO) {
    return naive_total<SPECIES>(p, e0, e1, e2, clouds, H, W, bilinear, c);
  } else {
    const float r = length(p);
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r > CLOUDS_LOWER_F && r < CLOUDS_UPPER_F) sphere_tap<4>(clouds, H, W, p, bilinear, s);
    return e0 * naive_shape_density(s[0], r);
  }
}

// Delta tracking (RATIO false: event, t, iid; an invalid lane keeps (0,
// t_start, 0)) or the cloud's ratio tracking (RATIO: the transmittance; an
// invalid lane keeps 1) over [t_start, tm] at the global majorant max_ext,
// as warp-cooperative steps. The extinctions: the gases' three (SPECIES
// NAIVE_RMO), or the cloud's in e0. With ``iters`` the lane's steps are
// written there.
template <int SPECIES, bool RATIO>
__device__ __forceinline__ NaiveTrack naive_track_warp(Key key, V3 o, V3 d, float t_start,
                                                       float tm, float e0, float e1, float e2,
                                                       float max_ext, bool active,
                                                       const uint8_t* __restrict__ clouds, int H,
                                                       int W, bool bilinear, int max_steps,
                                                       int* iters = nullptr) {
  static_assert(SPECIES == NAIVE_CLOUD || !RATIO,
                "the gases' ratio tracking is rmo_ratio_lane's loop (rmo_track.cuh)");
  const float albedo[4] = {1.0f, 0.95f, 0.0f, 0.99f};  // constants.SCATTERING_ALBEDOS
  const float inv_max = 1.0f / max_ext;
  const int lane = threadIdx.x & 31;
  NaiveTrack out{0, 0, t_start, 1.0f};  // the lane's state, on its own thread
  int it = 0;
  bool done = !(active && (tm >= 0.0f) && (t_start < tm)) || max_steps <= 0;
  for (unsigned trk = __ballot_sync(NAIVE_FULL_WARP, !done); trk;
       trk = __ballot_sync(NAIVE_FULL_WARP, !done)) {
    // 1. T threads a tracking lane (warp-uniform)
    const int c = __popc(trk);
    int T = 32;
    while (T > 1 && c * T > 32) T >>= 1;
    const bool grouped = T > 1;
    const int lg = __ffs(T) - 1, base = lane & ~(T - 1), sub = lane & (T - 1);
    const unsigned ones = T == 32 ? NAIVE_FULL_WARP : (1u << T) - 1u;
    // 2. the group's lane: the (lane / T)-th tracking lane, or the thread's own
    const bool gact = grouped ? (lane >> lg) < c : !done;
    const int src = grouped && gact ? nth_set_bit(trk, lane >> lg) : lane;
    const auto sh = [&](auto x) { return grouped ? __shfl_sync(NAIVE_FULL_WARP, x, src) : x; };
    const Key gk{sh(key.k0), sh(key.k1)};
    const V3 go{sh(o.x), sh(o.y), sh(o.z)}, gd{sh(d.x), sh(d.y), sh(d.z)};
    const float gtm = sh(tm), ginv = sh(inv_max), gt = sh(out.t), ge0 = sh(e0);
    const int gi = sh(it);
    float ge1 = 0.0f, ge2 = 0.0f, gmax = 0.0f;
    if constexpr (SPECIES == NAIVE_RMO) {
      ge1 = sh(e1);
      ge2 = sh(e2);
      gmax = sh(max_ext);
    }
    const int gnv = gact ? min(T, max_steps - gi) : 0;  // the round's steps of the group
    // 3. this thread's step, its position from the chain, its density
    const bool live = sub < gnv;
    Key kj{0u, 0u};
    float p = 0.0f;
    if (live) {
      kj = fold(gk, (uint32_t)(gi + sub));
      p = logf(fmaxf(uniform(kj, 0u), 1e-12f)) * ginv;
    }
    float tj = gt - p;
    if (grouped) {
      float tc = gt;
      for (int q = 0; q < T; ++q) {
        tc = tc - __shfl_sync(NAIVE_FULL_WARP, p, base + q);
        if (q == sub) tj = tc;
      }
    }
    const bool over = tj >= gtm;
    float total = 0.0f, terms[3] = {0.0f, 0.0f, 0.0f};
    if (live && !over) {
      total = naive_total_skip<SPECIES>(along(go, fminf(tj, fmaxf(gtm, 0.0f)), gd), ge0, ge1, ge2,
                                        clouds, H, W, bilinear, terms);
    }
    // 4.-5. the first stop in step order; the lane's thread takes the outcome
    const int ob = grouped ? __popc(trk & ((1u << lane) - 1u)) << lg : lane;  // its group
    const int nv = min(T, max_steps - it);
    if constexpr (RATIO) {
      const float f = 1.0f - total * ginv;
      const unsigned overs = __ballot_sync(NAIVE_FULL_WARP, live && over);
      float tr = sh(out.trans);
      int stop_at = -1;
      for (int q = 0; q < T; ++q) {
        const float fq = grouped ? __shfl_sync(NAIVE_FULL_WARP, f, base + q) : f;
        if (stop_at < 0 && q < gnv) {
          if ((overs >> (base + q)) & 1u) {
            stop_at = q;  // past t_max: the transmittance stays
          } else {
            tr = tr * fq;
            if (tr < 1e-5f) stop_at = q;
          }
        }
      }
      const int rd = done ? lane : ob, rdt = done ? lane : ob + nv - 1;
      const float tr_r = grouped ? __shfl_sync(NAIVE_FULL_WARP, tr, rd) : tr;
      const int at_r = grouped ? __shfl_sync(NAIVE_FULL_WARP, stop_at, rd) : stop_at;
      const float t_r = grouped ? __shfl_sync(NAIVE_FULL_WARP, tj, rdt) : tj;
      if (!done) {
        it += at_r >= 0 ? at_r + 1 : nv;
        out.trans = tr_r;
        out.t = t_r;
        done = at_r >= 0 || it >= max_steps;
      }
    } else {
      const float thr = total * ginv;
      float u1 = 0.0f;
      bool hit = false;
      if (live && !over && thr > 0.0f) {
        u1 = uniform(kj, 1u);
        hit = u1 < thr;
      }
      const unsigned stops = __ballot_sync(NAIVE_FULL_WARP, live && (over || hit));
      // the group's first stop draws the event where it is one
      int pack = 0;  // event | iid << 2
      if (hit && lane == __ffs(stops & (ones << base)) - 1) {
        int id = 3;
        if constexpr (SPECIES == NAIVE_RMO) {
          const float r = u1 * gmax;
          const float c01 = terms[0] + terms[1];
          id = r < terms[0] ? 0 : (r < c01 ? 1 : 2);
        }
        pack = (uniform(kj, 2u) < albedo[id] ? 2 : 1) | (id << 2);
      }
      const unsigned st = done ? 0u : stops & (ones << ob);
      const int rd = done ? lane : (st ? __ffs(st) - 1 : ob + nv - 1);
      const float t_r = grouped ? __shfl_sync(NAIVE_FULL_WARP, tj, rd) : tj;
      const int pack_r = grouped ? __shfl_sync(NAIVE_FULL_WARP, pack, rd) : pack;
      if (!done) {
        it += rd - ob + 1;
        out.t = t_r;
        out.event = pack_r & 3;
        out.iid = pack_r >> 2;
        done = st != 0u || it >= max_steps;
      }
    }
  }
  if (iters) *iters = it;
  return out;
}

}  // namespace de
