// Threefry-2x32 (20 rounds) and the per-lane key chain of JAX's
// ``jax.random.fold_in`` / ``jax.random.uniform`` under
// jax_threefry_partitionable=True, bit for bit (replaces
// digital_earth_tpu/ops/rng.py:33-64, mirrored in Python by
// digital_earth_tpu_torch/ops/rng.py).
//
//   fold(key, d)        = threefry2x32(key; (0, d))
//   uniform(key, j)     = float from the word y0 ^ y1 of threefry2x32(key; (0, j)),
//                         ((bits >> 9) | 0x3F800000) - 1, j the flat draw index
//
// What bounds it on the H100: integer issue on the ALU pipe, which takes 16
// lanes a clock per SM sub-partition. ptxas compiles a block to 68 SASS
// instructions (chip_smoke.py reads them from csrc/threefry_check.cu): on
// the ALU pipe 20 rotates of one funnel shift each (SHF.L.W), 21 LOP3 (the
// xors and ks[2]) and 9 IADD3, on the FMA pipe 17 IMAD.IADD, and a VIADD.
// That is the fewest a block allows with an add, a rotate and a xor a
// round: ptxas itself folds x0 = 0 and each key injection into the next
// round's three-input add, and issues the rounds' two-input adds on the
// FMA pipe. So the loop below stays as written. Written out by hand (the
// folded injections, the adds forced onto IMAD, a key's ks[2] made once, a
// site's draws from one key interleaved), the block stayed the same 68
// instructions and the bounce entries' device time did not move; rotates
// as 64-bit multiplies on the FMA pipe (IMAD.WIDE) were slower (PERF.md).
#pragma once
#include <cstdint>

namespace de {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int b = 0; b < 5; ++b) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[b & 1][r]);
      x1 ^= x0;
    }
    x0 += ks[(b + 1) % 3];
    x1 += ks[(b + 2) % 3] + (uint32_t)(b + 1);
  }
}

__device__ __forceinline__ Key load_key(const int32_t* keys, int lane) {
  return Key{(uint32_t)keys[2 * lane], (uint32_t)keys[2 * lane + 1]};
}

__device__ __forceinline__ Key fold(Key k, uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry2x32(k.k0, k.k1, x0, x1);
  return Key{x0, x1};
}

__device__ __forceinline__ float uniform(Key k, uint32_t idx) {
  uint32_t x0 = 0u, x1 = idx;
  threefry2x32(k.k0, k.k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace de
