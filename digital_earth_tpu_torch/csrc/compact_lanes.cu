// compact_lanes: the next bounce's list of live lanes, binned by work class,
// as a stable counting sort of all N lanes by key = alive ? clip(work_class,
// 0, 2) : 3, in one launch.
//
// Replaces the TPU stage compactor digital_earth_tpu/render/renderer.py:84
// _compact_by_alive (cumsum ranks, one scatter to build the permutation).
// It writes the ids of the alive lanes, bin 0 first, each bin in lane order,
// into out[0:n_live], and n_live as one int32 on the device; the dead bin is
// not written. Integers only, so kernel and plain twin
// (render/compact.compact_by_alive_plain) agree bit for bit.
//
// One launch after a reset of its scratch (cudaMemsetAsync, counted as a
// second launch), as a single-pass scan with decoupled look-back (Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016) over tiles of 8192 lanes (512 threads, 16 lanes each, loaded
// coalesced):
//   A. a block takes tiles in the order of an atomic ticket, counts each
//      tile's lanes of the three alive bins (warp ballots and __popc per
//      (item, warp) slot, one warp per bin summing the slots),
//      publishes the three counts with an "aggregate" flag, then one warp
//      per bin looks back over the earlier tiles, 32 at a time, summing
//      aggregates until it meets an "inclusive" prefix, and publishes its own
//      inclusive prefix. A block waits only on tiles that running blocks
//      took before it. The last tile's inclusive prefixes are the bins'
//      totals: its block writes them and n_live.
//   B. the bins' bases need those totals, so the scatter is a second
//      ticketed sweep of the same launch: each block waits for the totals,
//      then per tile recounts its ballots, scans the slots' counts (one warp
//      per bin), takes the tile's exclusive offset (its inclusive prefix less
//      its count) and writes each lane's id at its bin's base + the tile's
//      offset + the counts of the tile's earlier slots + its rank in its
//      warp. Every tile was taken in A by a block that is running, so no
//      block waits forever, whatever the grid.
// The grid is the blocks that fit on the card at once (at most one per
// tile): at 1080p the 254 tiles are all in flight at once, so each block's
// chain of dependent steps (ticket, loads, look-back) is paid about once per
// sweep, not once per tile of a long sequence.
//
// What bounds it on the H100: bytes and latency. It reads 5 B per lane
// twice and writes 4 B per live lane (about 25 MB at 1080p, 8 us of HBM
// time); the look-back's chain of dependent loads and the launch itself are
// the rest.
#include <cstdint>

#include <cuda_runtime.h>

namespace de {

constexpr int CL_BLOCK = 512;                   // threads per block
constexpr int CL_WARPS = CL_BLOCK / 32;
constexpr int CL_ITEMS = 16;                    // lanes per thread and tile
constexpr int CL_TILE = CL_BLOCK * CL_ITEMS;    // lanes per tile
constexpr int CL_SLOTS = CL_ITEMS * CL_WARPS;   // (item, warp) slots of a tile
constexpr int CL_BINS = 3;  // alive work classes; bin 3 holds the dead lanes
constexpr int CL_HEADER = 8;  // int32 words before the status words
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;
constexpr unsigned long long FLAG_INCLUSIVE = 2ull << 32;

// scratch header (int32): ticket of sweep A, ticket of sweep B, totals
// ready, pad, totals of the three bins, pad; then (n_tiles, 3) status words
// of 64 bits: flag << 32 | count.
enum { H_TICKET_A, H_TICKET_B, H_READY, H_PAD, H_TOTALS };

__device__ __forceinline__ int lane_bin(const bool* __restrict__ alive,
                                        const int32_t* __restrict__ wc, int n, long long i) {
  if (i >= n || !alive[i]) return CL_BINS;
  return min(max(wc[i], 0), CL_BINS - 1);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ int take_ticket(int* ticket, int* shared_tile) {
  if (threadIdx.x == 0) *shared_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = *shared_tile;
  __syncthreads();  // every thread has read it before the next ticket
  return tile;
}

// A tile's lanes are tile * CL_TILE + item * CL_BLOCK + thread (coalesced
// loads; the tile's lane order is item-major, then warp, then lane). This
// thread's CL_ITEMS bins, two bits each, and each (item, warp) slot's count
// of each alive bin into counts (warp ballots).
__device__ __forceinline__ unsigned bin_tile(const bool* __restrict__ alive,
                                             const int32_t* __restrict__ wc, int n, int tile,
                                             int (*counts)[CL_BINS]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)tile * CL_TILE + threadIdx.x;
  unsigned packed = 0;
#pragma unroll
  for (int j = 0; j < CL_ITEMS; ++j) {
    const int bin = lane_bin(alive, wc, n, base + (long long)j * CL_BLOCK);
    packed |= (unsigned)bin << (2 * j);
#pragma unroll
    for (int b = 0; b < CL_BINS; ++b) {
      const unsigned mask = __ballot_sync(FULL_MASK, bin == b);
      if (lane == 0) counts[j * CL_WARPS + warp][b] = __popc(mask);
    }
  }
  __syncthreads();
  return packed;
}

// Warp b (< CL_BINS): the tile's count of bin b, and with scan, each slot's
// exclusive prefix of it in place of its count.
__device__ __forceinline__ int warp_bin_sum(int (*counts)[CL_BINS], int b, bool scan) {
  const int lane = threadIdx.x & 31;
  constexpr int PER = CL_SLOTS / 32;
  int v[PER], sum = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    v[k] = counts[lane * PER + k][b];
    sum += v[k];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  const int total = __shfl_sync(FULL_MASK, incl, 31);
  if (scan) {
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      counts[lane * PER + k][b] = run;
      run += v[k];
    }
  }
  return total;
}

__global__ void __launch_bounds__(CL_BLOCK)
    compact_kernel(const bool* __restrict__ alive, const int32_t* __restrict__ wc, int n,
                   int32_t* __restrict__ out, int32_t* __restrict__ n_live, int* hdr,
                   unsigned long long* status, int n_tiles) {
  __shared__ int counts[CL_SLOTS][CL_BINS];
  __shared__ int tile_s, incl_s[CL_BINS], base_s[CL_BINS], off_s[CL_BINS];
  if (n_tiles == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) n_live[0] = 0;
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // A. the tiles' counts and the decoupled look-back
  for (;;) {
    const int tile = take_ticket(&hdr[H_TICKET_A], &tile_s);
    if (tile >= n_tiles) break;
    bin_tile(alive, wc, n, tile, counts);
    if (warp < CL_BINS) {
      const int b = warp;
      const int c = warp_bin_sum(counts, b, false);
      if (lane == 0) {
        store_status(&status[tile * CL_BINS + b],
                     (tile == 0 ? FLAG_INCLUSIVE : FLAG_AGGREGATE) | (unsigned)c);
        if (tile == 0) incl_s[b] = c;
      }
      if (tile > 0) {
        int prefix = 0;
        for (int pred = tile - 1;; pred -= 32) {
          const int p = pred - lane;
          unsigned long long st = FLAG_INCLUSIVE;  // before tile 0: an inclusive 0
          if (p >= 0) {
            do {
              st = load_status(&status[p * CL_BINS + b]);
            } while ((st >> 32) == 0);
          }
          const unsigned incl = __ballot_sync(FULL_MASK, (st >> 32) == 2);
          const int stop = incl ? __ffs(incl) - 1 : 31;
          int v = lane <= stop ? (int)(unsigned)st : 0;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
          prefix += v;
          if (incl) break;
        }
        if (lane == 0) {
          incl_s[b] = prefix + c;
          store_status(&status[tile * CL_BINS + b], FLAG_INCLUSIVE | (unsigned)incl_s[b]);
        }
      }
    }
    __syncthreads();
    if (tile == n_tiles - 1 && threadIdx.x == 0) {
      for (int b = 0; b < CL_BINS; ++b) hdr[H_TOTALS + b] = incl_s[b];
      n_live[0] = incl_s[0] + incl_s[1] + incl_s[2];
      __threadfence();
      *reinterpret_cast<volatile int*>(&hdr[H_READY]) = 1;
    }
  }

  // B. the scatter, once the totals are known
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile int*>(&hdr[H_READY]) == 0) {
    }
    __threadfence();
    const volatile int* totals = &hdr[H_TOTALS];
    base_s[0] = 0;
    base_s[1] = totals[0];
    base_s[2] = totals[0] + totals[1];
  }
  __syncthreads();
  for (;;) {
    const int tile = take_ticket(&hdr[H_TICKET_B], &tile_s);
    if (tile >= n_tiles) break;
    const unsigned packed = bin_tile(alive, wc, n, tile, counts);
    if (warp < CL_BINS) {
      const int b = warp;
      const int c = warp_bin_sum(counts, b, true);
      if (lane == 0) {
        unsigned long long st;
        do {
          st = load_status(&status[tile * CL_BINS + b]);
        } while ((st >> 32) != 2);
        off_s[b] = base_s[b] + (int)(unsigned)st - c;  // the bin's base + the tile's offset
      }
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    const long long base = (long long)tile * CL_TILE + threadIdx.x;
#pragma unroll
    for (int j = 0; j < CL_ITEMS; ++j) {
      const int bin = (packed >> (2 * j)) & 3;
#pragma unroll
      for (int b = 0; b < CL_BINS; ++b) {
        const unsigned mask = __ballot_sync(FULL_MASK, bin == b);
        if (bin == b) {
          out[off_s[b] + counts[j * CL_WARPS + warp][b] + __popc(mask & below)] =
              (int32_t)(base + (long long)j * CL_BLOCK);
        }
      }
    }
    __syncthreads();  // counts and off_s are reused by the next tile
  }
}

int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_kernel, CL_BLOCK, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 1;
    }
    cached[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  return cached[dev];
}

}  // namespace de

// alive (n,) bool, work_class (n,) int32 -> out (n,) int32 (the first
// n_live entries written), n_live (1,) int32; scratch holds
// de_compact_scratch_words(n) int32, reset here (one cudaMemsetAsync).
extern "C" int de_compact_scratch_words(int n) {
  const int n_tiles = (n + de::CL_TILE - 1) / de::CL_TILE;
  return de::CL_HEADER + 2 * de::CL_BINS * n_tiles;
}

extern "C" int de_compact_lanes(const bool* alive, const int32_t* work_class, int n,
                                int32_t* out, int32_t* n_live, int32_t* scratch,
                                void* stream) {
  const int n_tiles = (n + de::CL_TILE - 1) / de::CL_TILE;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * de_compact_scratch_words(n), st);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = n_tiles > 0 ? min(n_tiles, de::resident_blocks()) : 1;
  de::compact_kernel<<<grid, de::CL_BLOCK, 0, st>>>(
      alive, work_class, n, out, n_live, scratch,
      reinterpret_cast<unsigned long long*>(scratch + de::CL_HEADER), n_tiles);
  return (int)cudaGetLastError();
}
