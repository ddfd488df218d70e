// select_tiles: the k pixel tiles of highest estimated relative error, for
// an adaptive pass.
//
// Replaces digital_earth_tpu/render/renderer.py:425 _select_tiles
// (:439-466). Per pixel, with n = max(count, 1): mean_lum = lum(color) / n
// (Rec.709 weights), var_mean = max(lum2 / n - mean_lum^2, 0) / n; the frame
// mean m_bar of mean_lum; score = (var_mean + (0.2 m_bar)^2 / n^2) /
// (mean_lum + 0.2 m_bar + 1e-20)^2, +inf where count < 1; a tile's score is
// the mean of its pixels' (tile index bx * nby + by); the k largest in
// lax.top_k's order: descending, ties to the lower index.
//
// Two launches up to SORT_MAX tiles, four past it; deterministic, no float
// atomics, so the same buffers always give the same tiles (checkpoint resume
// depends on it):
//   A. (stages 1-2) mean_lum summed per chunk of 1024 consecutive pixels
//      (pixel id order); the last block to finish, by a ticket, sums the
//      chunk sums into m_bar;
//   B. (stages 3-4) one block per tile sums its pixels' scores (in-tile lane
//      order); the last block to finish ranks every tile by a bitonic sort
//      of the 64-bit keys (descending score in XLA's total order of float32,
//      as lax.top_k orders: -NaN < -inf < ... < -0 < +0 < ... < +inf <
//      +NaN) << 32 | tile, ascending, so ties go to the lower index (M = 4
//      keys per thread, 8 past 4096 tiles: strides below M in registers,
//      below 32 M by warp shuffles, the rest through shared memory), and
//      writes the first k
//      tiles. A NaN score (an infinite or NaN buffer value, say from a loaded
//      checkpoint) still gives every tile its own rank, and ids is always k
//      distinct tiles.
//   Past SORT_MAX = 8192 tiles (more than one block's sort holds) launch B
//   only scores, and the rank takes two launches of its own:
//   C. one block per run of 8192 tiles sorts the run's keys as above (8 a
//      thread) into scratch;
//   D. one thread per key adds its place in its own run to the count of
//      smaller keys in every other run (a binary search in each: the keys
//      are distinct, score bits << 32 | tile), which is its place in the
//      whole order, and writes its tile there if that is below k. Any
//      correct sort of distinct keys gives the same order, so the ids are
//      the twin's at every size.
// The ticket: each block writes its result, __threadfence(), then one
// atomicAdd on a counter in the caller's scratch; the block that draws the
// last ticket reads every block's result (all fenced before their tickets)
// and resets the counter to 0 for the next call. No block waits on another,
// and a call makes no host call between its launches, so a CUDA graph can
// capture it.
// A max with a bound keeps NaN, as torch.clamp and jnp.maximum do.
//
// Per device of a render mesh (digital_earth_tpu/parallel/mesh.py:189-204,
// make_sharded_adaptive_step) the same statistic runs on one device's flat
// tile-major shard, whose tile t holds pixels [t * tile, (t + 1) * tile) in
// in-tile lane order, with the frame mean m_bar coming in from the caller
// (the mean of the shards' means, each shard's from launch A):
//   de_shard_mean         launch A over the shard's pixels in lane order;
//   de_select_tiles_shard launch B over the shard's tiles, given m_bar.
// A device reads its shard twice (16 B per pixel for the mean, 20 B for the
// scores: 18.7 MB for a quarter of 1920x1080) and ranks its own tiles.
// Every sum is the same halving tree over a zero-padded power-of-two array,
// s[i] += s[i + h] for h = p/2, ..., 1, which the plain version
// (render/adaptive.select_tiles_plain) repeats, so the two agree bit for bit:
// the levels down to h = TREE_SLOTS (4096; only the first, h = p/2, up to
// p = 8192) add in registers as each thread loads its slot's p / TREE_SLOTS
// elements, the levels down to h = 64 in shared memory, and h = 32 ... 1 in
// warp 0's registers by __shfl_down_sync (lane i adds lane i + h: the
// operands of s[i] + s[i + h] in their order), so a 2048-element tree takes
// 5 barriers (11 with every level in shared memory). A slot's upper levels
// are the halving tree over its elements x[i + j TREE_SLOTS], j < r: folded
// in the tree's in-order, leaf j = bit-reversal of the visit count, with a
// stack of log2(r) partial sums, so a tile of any size or a frame of any
// number of chunks sums in the twin's order with the same shared memory.
//
// What bounds it on the H100: bytes. It reads the three buffers once (20 B
// per pixel, 41.5 MB at 1920x1080); about 20 flops per pixel. The chunk
// stage reads color as 16-byte vectors staged in shared memory (a chunk is
// 12 KB contiguous); a tile of the (W, H) image is bw runs of bh pixels,
// read a float at a time.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace de {

constexpr int CHUNK = 1024;         // pixels per partial sum of stage 1
// Threads of a chunk block (two pairs of the tree's first level each) and at
// most of a tile block's tree (a 1920-pixel tile: four pairs each): small
// blocks with several loads in flight per thread, so that a 1080p frame's
// chunks or tiles are resident at about once and their loads overlap.
constexpr int CHUNK_THREADS = 256;
constexpr int TILE_THREADS = 256;
// Keys per thread of the rank's sort: 4 keeps the kernel at 30 registers, so
// that 8 tile blocks of 256 threads are resident per SM (8 keys took 44);
// past 4096 tiles a block of 1024 threads sorts 8 each.
constexpr int SORT_M = 4, SORT_M_LARGE = 8;
// The most tiles one block ranks (1024 threads of SORT_M_LARGE keys), and the
// keys of each run that launch C sorts past it.
constexpr int SORT_MAX = 1024 * SORT_M_LARGE;
constexpr int TREE_SLOTS = 4096;    // the tree's shared slots (floats)
constexpr int RANK_THREADS = 256;
constexpr unsigned FULL_WARP = 0xffffffffu;

struct SelectParams {
  float lum_w[3];
  float fifth;   // float32(0.2)
  float tiny;    // float32(1e-20)
};

// Slot i of the halving tree's level h = w over x[0..w r) (w, r powers of
// two, r >= 2): the tree over the r elements x[i + j w], which pairs j with
// j + r/2 first. Its in-order visits leaf j = bit-reversal of the visit
// count k (log2 r bits), and after each leaf a trailing one of k closes a
// subtree: the stack's top plus the value so far, left operand first.
template <class Get>
__device__ __forceinline__ float fold_slot(Get get, int i, int w, int r) {
  float stack[32];
  int depth = 0;
  const int bits = __ffs(r) - 1;
  for (int k = 0; k < r; ++k) {
    float v = get(i + (int)(__brev((unsigned)k) >> (32 - bits)) * w);
    for (int c = k; c & 1; c >>= 1) v = stack[--depth] + v;
    stack[depth++] = v;
  }
  return stack[0];
}

// The halving tree over x[0..p) (p a power of two, x[i] = get(i), 0 past
// the data), s holding min(p/2, TREE_SLOTS) floats: s[i] = s[i] + s[i + h]
// for h = p/2, ..., 1, the levels down to h = min(p/2, TREE_SLOTS) in
// registers, the levels down to h = 64 in s, the rest in warp 0 by
// shuffles. The sum is valid in thread 0; a caller that reuses s syncs
// first.
template <class Get>
__device__ __forceinline__ float tree_sum(Get get, int p, float* s) {
  const int t = threadIdx.x, nt = blockDim.x;
  float v = 0.0f;
  if (p >= 128) {
    const int half = min(p >> 1, TREE_SLOTS);
    if (p == 2 * half) {
      for (int i = t; i < half; i += nt) s[i] = get(i) + get(i + half);
    } else {
      for (int i = t; i < half; i += nt) s[i] = fold_slot(get, i, half, p / half);
    }
    __syncthreads();
    for (int h = half >> 1; h >= 64; h >>= 1) {
      for (int i = t; i < h; i += nt) s[i] = s[i] + s[i + h];
      __syncthreads();
    }
    if (t < 32) v = s[t] + s[t + 32];
  } else if (p == 64) {
    if (t < 32) v = get(t) + get(t + 32);
  } else if (t < 32) {
    v = t < p ? get(t) : 0.0f;
  }
  if (t < 32) {
    for (int h = min(16, p >> 1); h >= 1; h >>= 1) v = v + __shfl_down_sync(FULL_WARP, v, h);
  }
  return v;
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// The float's place in XLA's total order, as a signed integer.
__device__ __forceinline__ int32_t order_key(float x) {
  const int32_t b = __float_as_int(x);
  return b < 0 ? b ^ 0x7FFFFFFF : b;
}

__device__ __forceinline__ float lum3(float c0, float c1, float c2, const SelectParams& p) {
  return c0 * p.lum_w[0] + c1 * p.lum_w[1] + c2 * p.lum_w[2];
}

__device__ __forceinline__ float pixel_lum(const float* __restrict__ color, int64_t px,
                                           const SelectParams& p) {
  return lum3(color[3 * px], color[3 * px + 1], color[3 * px + 2], p);
}

// True in every thread of the block that drew the grid's last ticket, after
// this block's result was written (by thread 0) and fenced.
__device__ __forceinline__ bool last_block(unsigned* counter) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// Launch A: each block's chunk of 1024 pixels summed into partial[block];
// the last block sums the n_part partials (in a tree of p2) into out[0] =
// sum / n_pix. Dynamic shared memory: max(CHUNK * 3 + CHUNK / 2, min(p2 / 2,
// TREE_SLOTS)) floats.
__global__ void __launch_bounds__(CHUNK_THREADS)
    frame_mean(const float* __restrict__ color, const float* __restrict__ count, int64_t n_pix,
               float* __restrict__ partial, int p2, float* __restrict__ out, unsigned* counter,
               SelectParams p) {
  extern __shared__ float smem[];
  float* rgb = smem;              // the chunk's color, CHUNK * 3 floats
  float* s = smem + 3 * CHUNK;    // the tree, CHUNK / 2 floats
  const int64_t base = (int64_t)blockIdx.x * CHUNK;
  const int64_t rest = n_pix - base;
  const int valid = rest < CHUNK ? (int)rest : CHUNK;
  const float* c = color + 3 * base;
  if (((uintptr_t)c & 15) == 0) {
    const int full = (3 * valid) / 4;  // whole 16-byte vectors
    for (int i = threadIdx.x; i < full; i += blockDim.x)
      reinterpret_cast<float4*>(rgb)[i] = __ldg(reinterpret_cast<const float4*>(c) + i);
    for (int i = 4 * full + threadIdx.x; i < 3 * valid; i += blockDim.x) rgb[i] = c[i];
  } else {
    for (int i = threadIdx.x; i < 3 * valid; i += blockDim.x) rgb[i] = c[i];
  }
  __syncthreads();
  const float* cnt = count + base;
  const float sum = tree_sum(
      [&](int i) {
        return i < valid ? lum3(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], p) /
                               clamp_min(cnt[i], 1.0f)
                         : 0.0f;
      },
      CHUNK, s);
  if (threadIdx.x == 0) partial[blockIdx.x] = sum;
  if (!last_block(counter)) return;
  const int n_part = gridDim.x;
  const float total = tree_sum(
      [&](int i) { return i < n_part ? __ldcg(partial + i) : 0.0f; }, p2, smem);
  if (threadIdx.x == 0) {
    out[0] = total / (float)n_pix;
    *counter = 0u;
  }
}

// One in-thread stage of the bitonic sort: keys t M + m and t M + (m ^ J).
template <int M, int J>
__device__ __forceinline__ void sort_stage_in_thread(unsigned long long (&v)[M], int t,
                                                     int size) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if ((m ^ J) > m) {
      const bool asc = ((t * M + m) & size) == 0;
      const unsigned long long a = v[m], b = v[m ^ J];
      if ((a > b) == asc) {
        v[m] = b;
        v[m ^ J] = a;
      }
    }
  }
}

// An ascending bitonic sort of n = M * (n / M) keys, thread t holding keys
// [t M, t M + M) in v (threads t < n / M take part; n / M is a multiple of
// 32; every thread of the block calls it): strides below M within a thread,
// below 32 M across a warp by shuffles, the rest through shared memory
// (key, n entries, slot m of thread t at m (n / M) + t, so a warp's
// accesses are consecutive), so a 2048-key sort takes 20 barriers at M = 4.
template <int M>
__device__ __forceinline__ void bitonic_sort(unsigned long long (&v)[M], int n,
                                             unsigned long long* key) {
  static_assert(M == 4 || M == 8, "the in-thread strides below");
  const int t = threadIdx.x, nt = n / M;
  const bool act = t < nt;
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= 32 * M) {
        if (act) {
#pragma unroll
          for (int m = 0; m < M; ++m) key[m * nt + t] = v[m];
        }
        __syncthreads();
        if (act) {
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int e = t * M + m;
            const unsigned long long pv = key[m * nt + ((e ^ j) / M)];
            const bool keep_min = ((e & j) == 0) == ((e & size) == 0);
            v[m] = keep_min == (pv < v[m]) ? pv : v[m];
          }
        }
        __syncthreads();
      } else if (j >= M) {
        if (act) {
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int e = t * M + m;
            const unsigned long long pv = __shfl_xor_sync(FULL_WARP, v[m], j / M);
            const bool keep_min = ((e & j) == 0) == ((e & size) == 0);
            v[m] = keep_min == (pv < v[m]) ? pv : v[m];
          }
        }
      } else if (act) {
        if constexpr (M == 8) {
          if (j == 4) sort_stage_in_thread<M, 4>(v, t, size);
        }
        if (j == 2) sort_stage_in_thread<M, 2>(v, t, size);
        else if (j == 1) sort_stage_in_thread<M, 1>(v, t, size);
      }
    }
  }
}

// Tile i's rank key: (~biased order key) << 32 | i, ascending = descending
// score, ties to the lower tile.
__device__ __forceinline__ unsigned long long rank_key(const float* score, int i) {
  const uint32_t up = (uint32_t)order_key(__ldcg(score + i)) ^ 0x80000000u;
  return ((unsigned long long)(~up) << 32) | (uint32_t)i;
}

// Launch B: one block per tile sums its pixels' scores against m_bar into
// score[tile]; with M > 0 the last block sorts every tile's key (n2 keys,
// padded) and writes ids[0..k), M keys to a thread (M = 0: launches C and D
// rank them).
// flat: the buffers are a tile-major shard (tile t at [t * bw * bh, ...)),
// else a (W, H) image whose tile t is block (t / nby, t % nby). Dynamic
// shared memory: max(min(pt / 2, TREE_SLOTS) floats, n2 keys of 8 bytes).
template <int M>
__global__ void __launch_bounds__(M == 0 ? TILE_THREADS : 1024, M == SORT_M ? 2 : 1)
    tile_select(const float* __restrict__ color, const float* __restrict__ count,
                const float* __restrict__ lum2, const float* __restrict__ m_bar, int h, int bw,
                int bh, int pt, int flat, int n2, int k, float* __restrict__ score,
                int32_t* __restrict__ ids, unsigned* counter, SelectParams p) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int nby = h / bh;
  const int bx = tile / nby, by = tile % nby;
  const int n_tile = bw * bh;
  const float m = m_bar[0];
  const float anchor = p.fifth * m + p.tiny;
  const float e = p.fifth * m;
  const float explore_num = e * e;
  const float sum = tree_sum(
      [&](int li) {
        if (li >= n_tile) return 0.0f;
        const int64_t px = flat ? (int64_t)tile * n_tile + li
                                : (int64_t)(bx * bw + li / bh) * h + (by * bh + li % bh);
        const float c = count[px];
        const float n = clamp_min(c, 1.0f);
        const float mean_lum = pixel_lum(color, px, p) / n;
        const float var_mean = clamp_min(lum2[px] / n - mean_lum * mean_lum, 0.0f) / n;
        const float explore = explore_num / (n * n);
        const float d = mean_lum + anchor;
        return c < 1.0f ? INFINITY : (var_mean + explore) / (d * d);
      },
      pt, smem);
  if (threadIdx.x == 0) score[tile] = sum / (float)n_tile;
  if constexpr (M > 0) {
    if (!last_block(counter)) return;

    // the rank: an ascending sort of the tiles' keys
    const int n_tiles = gridDim.x;
    unsigned long long v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = threadIdx.x * M + m;
      v[m] = i < n_tiles ? rank_key(score, i) : ~0ull;  // padding sorts last
    }
    bitonic_sort<M>(v, n2, reinterpret_cast<unsigned long long*>(smem));
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int r = threadIdx.x * M + m;
      if (threadIdx.x < n2 / M && r < k) ids[r] = (int32_t)(uint32_t)v[m];
    }
    if (threadIdx.x == 0) *counter = 0u;
  }
}

// Launch C (past SORT_MAX tiles): block b sorts the keys of tiles [b SORT_MAX,
// (b + 1) SORT_MAX) into runs[b SORT_MAX ...], padded with ~0 (which sorts
// after every tile's key: a key's low word is its tile, below 2^31). Dynamic
// shared memory: SORT_MAX keys of 8 bytes.
__global__ void __launch_bounds__(SORT_MAX / SORT_M_LARGE)
    sort_runs(const float* __restrict__ score, int n_tiles, unsigned long long* __restrict__ runs) {
  extern __shared__ unsigned long long keys[];
  constexpr int M = SORT_M_LARGE;
  const int64_t base = (int64_t)blockIdx.x * SORT_MAX;
  unsigned long long v[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int64_t i = base + threadIdx.x * M + m;
    v[m] = i < n_tiles ? rank_key(score, (int)i) : ~0ull;
  }
  bitonic_sort<M>(v, SORT_MAX, keys);
#pragma unroll
  for (int m = 0; m < M; ++m) runs[base + threadIdx.x * M + m] = v[m];
}

// The number of keys in the sorted run[0..SORT_MAX) below key.
__device__ __forceinline__ int keys_below(const unsigned long long* __restrict__ run,
                                          unsigned long long key) {
  int lo = 0, hi = SORT_MAX;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (run[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Launch D: the key in slot g of the runs goes to its place in the whole
// order, its place in its run plus the keys below it in the other runs;
// places below k write their tile to ids.
__global__ void __launch_bounds__(RANK_THREADS)
    rank_runs(const unsigned long long* __restrict__ runs, int n_runs, int k,
              int32_t* __restrict__ ids) {
  const int64_t g = (int64_t)blockIdx.x * RANK_THREADS + threadIdx.x;
  if (g >= (int64_t)n_runs * SORT_MAX) return;
  const unsigned long long key = runs[g];
  if (key == ~0ull) return;
  const int own = (int)(g / SORT_MAX);
  int64_t place = g - (int64_t)own * SORT_MAX;
  for (int q = 0; q < n_runs; ++q) {
    if (q != own) place += keys_below(runs + (int64_t)q * SORT_MAX, key);
  }
  if (place < k) ids[place] = (int32_t)(uint32_t)key;
}

static inline int next_pow2(int m) {
  int p = 1;
  while (p < m) p <<= 1;
  return p;
}

static inline SelectParams params(const float* fp) {
  SelectParams p;
  for (int j = 0; j < 3; ++j) p.lum_w[j] = fp[j];
  p.fifth = fp[3];
  p.tiny = fp[4];
  return p;
}

static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Launch A: the mean of mean_lum over n_pix pixels in buffer order.
static int mean_stage(const SelectParams& p, const float* color, const float* count,
                      int64_t n_pix, float* partial, float* mean, unsigned* counter,
                      cudaStream_t st) {
  const int64_t n_part = (n_pix + CHUNK - 1) / CHUNK;
  if (n_pix < 1 || n_part > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  const int p2 = next_pow2((int)n_part);
  const size_t smem =
      sizeof(float) * (size_t)std::max(3 * CHUNK + CHUNK / 2, std::min(p2 / 2, TREE_SLOTS));
  int rc = set_smem((const void*)frame_mean, smem);
  if (rc != 0) return rc;
  frame_mean<<<(int)n_part, CHUNK_THREADS, smem, st>>>(color, count, n_pix, partial, p2, mean,
                                                       counter, p);
  return (int)cudaGetLastError();
}

// Launch B: score the tiles against m_bar and write the k best ids; past
// SORT_MAX tiles launches C and D rank them through runs (the tile count
// rounded up to SORT_MAX keys).
static int select_stage(const SelectParams& p, const float* color, const float* count,
                        const float* lum2, const float* m_bar, int h, int bw, int bh,
                        int n_tiles, int flat, int k, float* score, int32_t* ids,
                        unsigned* counter, unsigned long long* runs, cudaStream_t st) {
  if (bw < 1 || bh < 1 || (int64_t)bw * bh > INT32_MAX / 2 || k < 1 || k > n_tiles)
    return (int)cudaErrorInvalidValue;
  const int pt = next_pow2(bw * bh);
  const int tree = std::min(pt / 2, TREE_SLOTS);
  // the tree's threads, one per slot up to TILE_THREADS, and at least warp 0
  // whole: tree_sum's last levels shuffle across all of its 32 lanes
  const int tree_threads = std::min(TILE_THREADS, std::max(tree, 32));
  int rc;
  if (n_tiles > SORT_MAX) {
    const size_t smem = sizeof(float) * (size_t)std::max(tree, 1);
    tile_select<0><<<n_tiles, tree_threads, smem, st>>>(color, count, lum2, m_bar, h, bw, bh, pt,
                                                        flat, 0, k, score, ids, counter, p);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    const int n_runs = (n_tiles + SORT_MAX - 1) / SORT_MAX;
    const size_t keys = sizeof(unsigned long long) * SORT_MAX;
    if ((rc = set_smem((const void*)sort_runs, keys)) != 0) return rc;
    sort_runs<<<n_runs, SORT_MAX / SORT_M_LARGE, keys, st>>>(score, n_tiles, runs);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    rank_runs<<<n_runs * (SORT_MAX / RANK_THREADS), RANK_THREADS, 0, st>>>(runs, n_runs, k, ids);
    return (int)cudaGetLastError();
  }
  // the sort's keys: a power of two, at least a warp's M each; M keys to a
  // thread, so that the sort's threads fit one block
  const int m = next_pow2(n_tiles) > 1024 * SORT_M ? SORT_M_LARGE : SORT_M;
  const int n2 = std::max(next_pow2(n_tiles), 32 * m);
  // at least the sort's threads
  const int threads = std::max(tree_threads, n2 / m);
  const size_t smem = std::max(sizeof(float) * (size_t)std::max(tree, 1),
                               sizeof(unsigned long long) * (size_t)n2);
  const void* fn = m == SORT_M ? (const void*)tile_select<SORT_M>
                               : (const void*)tile_select<SORT_M_LARGE>;
  if ((rc = set_smem(fn, smem)) != 0) return rc;
  if (m == SORT_M)
    tile_select<SORT_M><<<n_tiles, threads, smem, st>>>(color, count, lum2, m_bar, h, bw, bh, pt,
                                                        flat, n2, k, score, ids, counter, p);
  else
    tile_select<SORT_M_LARGE><<<n_tiles, threads, smem, st>>>(
        color, count, lum2, m_bar, h, bw, bh, pt, flat, n2, k, score, ids, counter, p);
  return (int)cudaGetLastError();
}

}  // namespace de

// fp: lum_w[3], 0.2, 1e-20 as float32 (5 floats)
// partial (ceil(w * h / 1024),), m_bar (1,), score (n_tiles,) and, past
// 8192 tiles, runs (n_tiles rounded up to 8192, 64-bit keys) are scratch the
// caller keeps, counter (2,) too: zero before the first call, each launch's
// last block leaves its counter at zero again.
extern "C" int de_select_tiles(const float* fp, const float* color, const float* count,
                               const float* lum2, int w, int h, int bw, int bh, int k,
                               float* partial, float* m_bar, float* score, unsigned* counter,
                               unsigned long long* runs, int32_t* ids, void* stream) {
  const de::SelectParams p = de::params(fp);
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = de::mean_stage(p, color, count, (int64_t)w * h, partial, m_bar, counter, st);
  if (rc != 0) return rc;
  if (bw < 1 || bh < 1) return (int)cudaErrorInvalidValue;
  return de::select_stage(p, color, count, lum2, m_bar, h, bw, bh, (w / bw) * (h / bh), 0, k,
                          score, ids, counter + 1, runs, st);
}

// One shard's mean of mean_lum over its n_pix pixels, into mean (1,);
// partial (ceil(n_pix / 1024),) and counter (1,) are scratch, as above.
extern "C" int de_shard_mean(const float* fp, const float* color, const float* count, int n_pix,
                             float* partial, unsigned* counter, float* mean, void* stream) {
  return de::mean_stage(de::params(fp), color, count, n_pix, partial, mean, counter,
                        (cudaStream_t)stream);
}

// The k best of one shard's n_tiles tiles of tile pixels each, scored
// against the frame mean m_bar (1,) on the device; score (n_tiles,),
// counter (1,) and runs (as de_select_tiles takes them) are scratch, ids (k,)
// the shard-local tile ids.
extern "C" int de_select_tiles_shard(const float* fp, const float* color, const float* count,
                                     const float* lum2, int n_tiles, int tile, int k,
                                     const float* m_bar, float* score, unsigned* counter,
                                     unsigned long long* runs, int32_t* ids, void* stream) {
  return de::select_stage(de::params(fp), color, count, lum2, m_bar, 1, tile, 1, n_tiles, 1, k,
                          score, ids, counter, runs, (cudaStream_t)stream);
}
