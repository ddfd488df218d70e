// The packet widths L (TraceConfig.hero_lambdas) a kernel library holds.
// The main library (kernels.library: every .cu of csrc/) holds L = 1 and
// L = 4. A width library (kernels.width_library) holds one other width: it
// is built with -DDE_WIDTH=L from the entries of bounce.cu, gen_rays.cu,
// rmo_ratio_track.cu and, past frame_end.cu's MAX_LAMBDAS, frame_end.cu,
// with the bounce entries' default and floor instances of width/*.cu, at
// first use.
#pragma once

#include <type_traits>

#include <cuda_runtime.h>

namespace de {

// f(std::integral_constant<int, L>{}) at the library's width L =
// n_lambdas; cudaErrorInvalidValue at a width the library does not hold.
template <class F>
int with_width(int n_lambdas, F&& f) {
#ifdef DE_WIDTH
  static_assert(DE_WIDTH >= 1, "a packet of at least one wavelength");
  if (n_lambdas == DE_WIDTH) return f(std::integral_constant<int, DE_WIDTH>{});
#else
  if (n_lambdas == 4) return f(std::integral_constant<int, 4>{});
  if (n_lambdas == 1) return f(std::integral_constant<int, 1>{});
#endif
  return (int)cudaErrorInvalidValue;
}

inline bool holds_width(int n_lambdas) {
  return with_width(n_lambdas, [](auto) { return 0; }) == 0;
}

}  // namespace de
