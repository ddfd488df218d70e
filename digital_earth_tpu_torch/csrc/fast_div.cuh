// x / d for 0 <= x < 2^31 by a divisor fixed per launch: a multiply-high and
// a shift, the round-up method of Granlund and Montgomery (1994) as
// CUTLASS's FastDivmod has it: p = 31 + ceil(log2 d), mul = ceil(2^p / d),
// x / d = umulhi(x, mul) >> (p - 32). Built on the host, passed by value.
#pragma once
#include <cstdint>

namespace de {

struct FastDiv {
  uint32_t d, mul, shift;
};

inline FastDiv make_fast_div(uint32_t d) {
  if (d <= 1) return FastDiv{1u, 0u, 0u};
  uint32_t log2 = 0;
  while ((1ull << log2) < d) ++log2;
  const uint32_t p = 31u + log2;
  return FastDiv{d, (uint32_t)(((1ull << p) + d - 1) / d), p - 32u};
}

__device__ __forceinline__ uint32_t fast_div(const FastDiv& f, uint32_t x) {
  return f.d == 1u ? x : __umulhi(x, f.mul) >> f.shift;
}

}  // namespace de
