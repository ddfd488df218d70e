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
// Four launches, deterministic, no float atomics, so the same buffers always
// give the same tiles (checkpoint resume depends on it):
//   1. mean_lum summed per chunk of 1024 consecutive pixels (pixel id order);
//   2. one block sums the chunk sums into m_bar;
//   3. one block per tile sums its pixels' scores (in-tile lane order);
//   4. rank selection: tile i has rank #{j : s_j > s_i or (s_j == s_i and
//      j < i)} and writes ids[rank] when rank < k. Scores compare in XLA's
//      total order of float32, as lax.top_k does (-NaN < -inf < ... < -0 <
//      +0 < ... < +inf < +NaN), so a NaN score (an infinite or NaN buffer
//      value, say from a loaded checkpoint) still gives every tile its own
//      rank, and ids is always k distinct tiles.
// A max with a bound keeps NaN, as torch.clamp and jnp.maximum do.
//
// Per device of a render mesh (digital_earth_tpu/parallel/mesh.py:189-204,
// make_sharded_adaptive_step) the same statistic runs on one device's flat
// tile-major shard, whose tile t holds pixels [t * tile, (t + 1) * tile) in
// in-tile lane order, with the frame mean m_bar coming in from the caller
// (the mean of the shards' means, each shard's from stages 1-2):
//   de_shard_mean         stages 1-2 over the shard's pixels in lane order;
//   de_select_tiles_shard stages 3-4 over the shard's tiles, given m_bar.
// A device reads its shard twice (16 B per pixel for the mean, 20 B for the
// scores: 18.7 MB for a quarter of 1920x1080) and ranks its own tiles.
// Every sum is the same halving tree over a zero-padded power-of-two array,
// s[i] += s[i + h] for h = p/2, ..., 1, which the plain version
// (render/adaptive.select_tiles_plain) repeats, so the two agree bit for bit.
//
// What bounds it on the H100: bytes. It reads the three buffers once (20 B
// per pixel, 41.5 MB at 1920x1080); about 20 flops per pixel, and the rank
// stage's n_tiles^2 comparisons (1.2M for 1080 tiles) from shared memory.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace de {

constexpr int CHUNK = 1024;      // pixels per partial sum of stage 1
constexpr int MAX_SHARED = 8192;  // floats of one block's tree (32 KB)

struct SelectParams {
  float lum_w[3];
  float fifth;   // float32(0.2)
  float tiny;    // float32(1e-20)
};

// The halving tree over s[0..p), p a power of two; the sum lands in s[0].
__device__ __forceinline__ void tree_sum(float* s, int p) {
  for (int h = p >> 1; h >= 1; h >>= 1) {
    for (int i = threadIdx.x; i < h; i += blockDim.x) s[i] = s[i] + s[i + h];
    __syncthreads();
  }
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// The float's place in XLA's total order, as a signed integer.
__device__ __forceinline__ int32_t order_key(float x) {
  const int32_t b = __float_as_int(x);
  return b < 0 ? b ^ 0x7FFFFFFF : b;
}

__device__ __forceinline__ float pixel_lum(const float* __restrict__ color, int64_t px,
                                           const SelectParams& p) {
  return color[3 * px] * p.lum_w[0] + color[3 * px + 1] * p.lum_w[1] +
         color[3 * px + 2] * p.lum_w[2];
}

__global__ void chunk_sums(const float* __restrict__ color, const float* __restrict__ count,
                           int64_t n_pix, float* __restrict__ partial, SelectParams p) {
  __shared__ float s[CHUNK];
  const int64_t base = (int64_t)blockIdx.x * CHUNK;
  for (int i = threadIdx.x; i < CHUNK; i += blockDim.x) {
    const int64_t px = base + i;
    s[i] = px < n_pix ? pixel_lum(color, px, p) / clamp_min(count[px], 1.0f) : 0.0f;
  }
  __syncthreads();
  tree_sum(s, CHUNK);
  if (threadIdx.x == 0) partial[blockIdx.x] = s[0];
}

__global__ void frame_mean(const float* __restrict__ partial, int n_part, int p2, float n_pix,
                           float* __restrict__ m_bar) {
  extern __shared__ float s[];
  for (int i = threadIdx.x; i < p2; i += blockDim.x) s[i] = i < n_part ? partial[i] : 0.0f;
  __syncthreads();
  tree_sum(s, p2);
  if (threadIdx.x == 0) m_bar[0] = s[0] / n_pix;
}

// flat: the buffers are a tile-major shard (tile t at [t * bw * bh, ...)),
// else a (W, H) image whose tile t is block (t / nby, t % nby).
__global__ void tile_scores(const float* __restrict__ color, const float* __restrict__ count,
                            const float* __restrict__ lum2, const float* __restrict__ m_bar,
                            int h, int bw, int bh, int pt, int flat, float* __restrict__ score,
                            SelectParams p) {
  extern __shared__ float s[];
  const int tile = blockIdx.x;
  const int nby = h / bh;
  const int bx = tile / nby, by = tile % nby;
  const int n_tile = bw * bh;
  const float m = m_bar[0];
  const float anchor = p.fifth * m + p.tiny;
  const float e = p.fifth * m;
  const float explore_num = e * e;
  for (int li = threadIdx.x; li < pt; li += blockDim.x) {
    float v = 0.0f;
    if (li < n_tile) {
      const int64_t px = flat ? (int64_t)tile * n_tile + li
                              : (int64_t)(bx * bw + li / bh) * h + (by * bh + li % bh);
      const float c = count[px];
      const float n = clamp_min(c, 1.0f);
      const float mean_lum = pixel_lum(color, px, p) / n;
      const float var_mean = clamp_min(lum2[px] / n - mean_lum * mean_lum, 0.0f) / n;
      const float explore = explore_num / (n * n);
      const float d = mean_lum + anchor;
      v = c < 1.0f ? INFINITY : (var_mean + explore) / (d * d);
    }
    s[li] = v;
  }
  __syncthreads();
  tree_sum(s, pt);
  if (threadIdx.x == 0) score[tile] = s[0] / (float)n_tile;
}

__global__ void rank_select(const float* __restrict__ score, int n_tiles, int k,
                            int32_t* __restrict__ ids) {
  extern __shared__ int32_t key[];
  for (int j = threadIdx.x; j < n_tiles; j += blockDim.x) key[j] = order_key(score[j]);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tiles) return;
  const int32_t ki = key[i];
  int rank = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int32_t kj = key[j];
    rank += (kj > ki) || (kj == ki && j < i);
  }
  if (rank < k) ids[rank] = i;
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

static inline int threads_for(int pt) { return pt >= 2048 ? 1024 : (pt >= 64 ? pt / 2 : 32); }

// Stages 1-2: the mean of mean_lum over n_pix pixels in buffer order.
static int mean_stages(const SelectParams& p, const float* color, const float* count,
                       int64_t n_pix, float* partial, float* mean, cudaStream_t st) {
  const int n_part = (int)((n_pix + CHUNK - 1) / CHUNK);
  const int p2 = next_pow2(n_part);
  if (p2 > MAX_SHARED) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  chunk_sums<<<n_part, 512, 0, st>>>(color, count, n_pix, partial, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  frame_mean<<<1, 1024, p2 * sizeof(float), st>>>(partial, n_part, p2, (float)n_pix, mean);
  return (int)cudaGetLastError();
}

// Stages 3-4: score the tiles against m_bar and write the k best ids.
static int select_stages(const SelectParams& p, const float* color, const float* count,
                         const float* lum2, const float* m_bar, int h, int bw, int bh,
                         int n_tiles, int flat, int k, float* score, int32_t* ids,
                         cudaStream_t st) {
  const int pt = next_pow2(bw * bh);
  if (pt > MAX_SHARED || n_tiles > MAX_SHARED || k < 1 || k > n_tiles)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  tile_scores<<<n_tiles, threads_for(pt), pt * sizeof(float), st>>>(
      color, count, lum2, m_bar, h, bw, bh, pt, flat, score, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int block = 256;
  rank_select<<<(n_tiles + block - 1) / block, block, n_tiles * sizeof(int32_t), st>>>(
      score, n_tiles, k, ids);
  return (int)cudaGetLastError();
}

}  // namespace de

// fp: lum_w[3], 0.2, 1e-20 as float32 (5 floats)
// partial (ceil(w * h / 1024),), m_bar (1,) and score (n_tiles,) are scratch.
extern "C" int de_select_tiles(const float* fp, const float* color, const float* count,
                               const float* lum2, int w, int h, int bw, int bh, int k,
                               float* partial, float* m_bar, float* score, int32_t* ids,
                               void* stream) {
  const de::SelectParams p = de::params(fp);
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = de::mean_stages(p, color, count, (int64_t)w * h, partial, m_bar, st);
  if (rc != 0) return rc;
  return de::select_stages(p, color, count, lum2, m_bar, h, bw, bh, (w / bw) * (h / bh), 0, k,
                           score, ids, st);
}

// One shard's mean of mean_lum over its n_pix pixels, into mean (1,);
// partial (ceil(n_pix / 1024),) is scratch.
extern "C" int de_shard_mean(const float* fp, const float* color, const float* count, int n_pix,
                             float* partial, float* mean, void* stream) {
  return de::mean_stages(de::params(fp), color, count, n_pix, partial, mean,
                         (cudaStream_t)stream);
}

// The k best of one shard's n_tiles tiles of tile pixels each, scored
// against the frame mean m_bar (1,) on the device; score (n_tiles,) is
// scratch, ids (k,) the shard-local tile ids.
extern "C" int de_select_tiles_shard(const float* fp, const float* color, const float* count,
                                     const float* lum2, int n_tiles, int tile, int k,
                                     const float* m_bar, float* score, int32_t* ids,
                                     void* stream) {
  return de::select_stages(de::params(fp), color, count, lum2, m_bar, 1, tile, 1, n_tiles, 1, k,
                           score, ids, (cudaStream_t)stream);
}
