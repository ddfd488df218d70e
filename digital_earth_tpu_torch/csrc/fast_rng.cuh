// The counter hash of the accelerated trackers at TraceConfig.fast_loop_rng
// (replaces digital_earth_tpu/ops/rng.py:66-113 _lowbias32, fast_uniform,
// mirrored in Python by digital_earth_tpu_torch/ops/rng.fast_uniform), bit
// for bit:
//
//   fast_uniform(key, c, j) = float(lowbias32(lowbias32(k1 ^ (c * 0x9E3779B9
//                             + j * 0x85EBCA6B)) ^ k0)) * 2^-32,
//
// c the loop counter, j the flat index of the draw in the loop's (3, K) or
// (K,) shape, the conversion rounded to nearest. Eleven integer operations
// a word where threefry's block takes 68 SASS instructions.
//
// loop_key and loop_uniform are an accelerated tracker's in-loop draw: with
// FAST (the instances built for TraceConfig.fast_loop_rng) the counter hash
// of the lane key, otherwise threefry's uniform(fold(key, i), j), as the
// default instances have always drawn.
#pragma once
#include <cstdint>

#include "threefry.cuh"

namespace de {

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float fast_uniform(Key key, uint32_t counter, uint32_t idx) {
  const uint32_t x = key.k1 ^ (counter * 0x9E3779B9u + idx * 0x85EBCA6Bu);
  return __uint2float_rn(lowbias32(lowbias32(x) ^ key.k0)) * 2.3283064365386963e-10f;
}

// The key iteration i of a tracker draws from: fold(key, i), or under the
// counter hash the lane key itself (the hash takes i).
template <bool FAST>
__device__ __forceinline__ Key loop_key(Key key, uint32_t i) {
  if constexpr (FAST) return key;
  else return fold(key, i);
}

// Draw j of iteration i from its loop_key ki.
template <bool FAST>
__device__ __forceinline__ float loop_uniform(Key ki, uint32_t i, uint32_t j) {
  if constexpr (FAST) return fast_uniform(ki, i, j);
  else return uniform(ki, j);
}

}  // namespace de
