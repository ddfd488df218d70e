// compact_lanes: the next bounce's list of live lanes, binned by work class,
// as a stable counting sort of all N lanes by key = alive ? clip(work_class,
// 0, 2) : 3.
//
// Replaces the TPU stage compactor digital_earth_tpu/render/renderer.py:84
// _compact_by_alive (cumsum ranks, one scatter to build the permutation).
// It writes the ids of the alive lanes, bin 0 first, each bin in lane order,
// into out[0:n_live], and n_live as one int32 on the device; the dead bin is
// not written. Three stages, integers only, so kernel and plain twin
// (render/compact.compact_by_alive_plain) agree bit for bit:
//   1. count: per block of 1024 lanes, the lanes of each alive bin (warp
//      ballots and __popc, then the 32 warps' counts);
//   2. scan: one block turns the (3, n_blocks) counts into exclusive
//      offsets within each bin, carrying a running total across chunks of
//      1024 blocks, and writes the bin bases and n_live;
//   3. scatter: each lane's destination is its bin's base + its block's
//      offset + the counts of the earlier warps of its block + its rank in
//      its warp (ballot and __popc of the lanes below it).
//
// What bounds it on the H100: bytes and launches. It reads 5 B per lane
// twice and writes 4 B per live lane (about 25 MB at 1080p, 8 us of HBM
// time); three launches of a few microseconds each replace the
// torch.nonzero gather and scatter of every state field.
#include <cstdint>

#include <cuda_runtime.h>

namespace de {

constexpr int CL_BLOCK = 1024;  // lanes per block, one per thread
constexpr int CL_BINS = 3;      // alive work classes; bin 3 holds the dead lanes
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

__device__ __forceinline__ int lane_bin(const bool* __restrict__ alive,
                                        const int32_t* __restrict__ wc, int n, int i) {
  if (i >= n || !alive[i]) return CL_BINS;
  return min(max(wc[i], 0), CL_BINS - 1);
}

__global__ void compact_count_kernel(const bool* __restrict__ alive,
                                     const int32_t* __restrict__ wc, int n,
                                     int32_t* __restrict__ counts, int nb) {
  __shared__ int warp_counts[CL_BLOCK / 32][CL_BINS];
  const int i = blockIdx.x * CL_BLOCK + threadIdx.x;
  const int bin = lane_bin(alive, wc, n, i);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < CL_BINS; ++b) {
    const unsigned mask = __ballot_sync(FULL_MASK, bin == b);
    if (lane == 0) warp_counts[warp][b] = __popc(mask);
  }
  __syncthreads();
  if (threadIdx.x < CL_BINS) {
    int total = 0;
    for (int w = 0; w < CL_BLOCK / 32; ++w) total += warp_counts[w][threadIdx.x];
    counts[threadIdx.x * nb + blockIdx.x] = total;
  }
}

// Inclusive scan of one value per thread over the block.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int out = x + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

// One block of CL_BLOCK threads: counts (3, nb) -> exclusive offsets within
// each bin; bases = (0, n0, n0 + n1), n_live = n0 + n1 + n2.
__global__ void compact_scan_kernel(int32_t* __restrict__ counts, int nb,
                                    int32_t* __restrict__ bases, int32_t* __restrict__ n_live) {
  __shared__ int warp_sums[CL_BLOCK / 32];
  __shared__ int totals[CL_BINS];
  __shared__ int chunk_total;
  for (int b = 0; b < CL_BINS; ++b) {
    int carry = 0;
    for (int base = 0; base < nb; base += CL_BLOCK) {
      const int i = base + threadIdx.x;
      const int v = i < nb ? counts[b * nb + i] : 0;
      const int incl = block_inclusive_scan(v, warp_sums);
      if (i < nb) counts[b * nb + i] = carry + incl - v;
      if (threadIdx.x == CL_BLOCK - 1) chunk_total = incl;  // the chunk's sum
      __syncthreads();
      carry += chunk_total;
      __syncthreads();
    }
    if (threadIdx.x == 0) totals[b] = carry;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bases[0] = 0;
    bases[1] = totals[0];
    bases[2] = totals[0] + totals[1];
    n_live[0] = totals[0] + totals[1] + totals[2];
  }
}

__global__ void compact_scatter_kernel(const bool* __restrict__ alive,
                                       const int32_t* __restrict__ wc, int n,
                                       const int32_t* __restrict__ offsets, int nb,
                                       const int32_t* __restrict__ bases,
                                       int32_t* __restrict__ out) {
  __shared__ int warp_counts[CL_BLOCK / 32][CL_BINS];
  const int i = blockIdx.x * CL_BLOCK + threadIdx.x;
  const int bin = lane_bin(alive, wc, n, i);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int rank = 0;
#pragma unroll
  for (int b = 0; b < CL_BINS; ++b) {
    const unsigned mask = __ballot_sync(FULL_MASK, bin == b);
    if (lane == 0) warp_counts[warp][b] = __popc(mask);
    if (bin == b) rank = __popc(mask & below);
  }
  __syncthreads();
  if (bin < CL_BINS) {
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_counts[w][bin];
    out[bases[bin] + offsets[bin * nb + blockIdx.x] + before + rank] = i;
  }
}

}  // namespace de

// alive (n,) bool, work_class (n,) int32 -> out (n,) int32 (the first
// n_live entries written), n_live (1,) int32; scratch holds 3 * nb + 4
// int32 with nb = ceil(n / 1024).
extern "C" int de_compact_lanes(const bool* alive, const int32_t* work_class, int n,
                                int32_t* out, int32_t* n_live, int32_t* scratch,
                                void* stream) {
  const int nb = (n + de::CL_BLOCK - 1) / de::CL_BLOCK;
  int32_t* counts = scratch;
  int32_t* bases = scratch + 3 * nb;
  cudaStream_t st = (cudaStream_t)stream;
  if (nb > 0) {
    de::compact_count_kernel<<<nb, de::CL_BLOCK, 0, st>>>(alive, work_class, n, counts, nb);
  }
  de::compact_scan_kernel<<<1, de::CL_BLOCK, 0, st>>>(counts, nb, bases, n_live);
  if (nb > 0) {
    de::compact_scatter_kernel<<<nb, de::CL_BLOCK, 0, st>>>(alive, work_class, n, counts, nb,
                                                            bases, out);
  }
  return (int)cudaGetLastError();
}
