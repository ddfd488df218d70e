// Spectral colour functions as device code, rounding op by op in the order
// of the plain versions in ops/spectral.py (digital_earth_tpu/ops/spectral.py).
#pragma once

namespace de {

// Blackbody SPD with nm-scaled constants (ops/spectral.plancks): ``a`` is
// float32(2 h c^2), ``b`` float32(h c); wavelength^5 by the reference's
// binary exponentiation, wl * (wl^2)^2.
__device__ __forceinline__ float plancks(float wl, float temperature, float a, float b,
                                         float k) {
  const float wl2 = wl * wl;
  const float wl5 = wl * (wl2 * wl2);
  const float p1 = a / wl5;
  const float p2 = expf(b / ((wl * k) * temperature)) - 1.0f;
  return p1 / p2;
}

// Spectral power of an sRGB triple through the 300-bin (400-700 nm) basis
// ``lut`` (300, 3), as ops/spectral.srgb_to_spectrum computes it: the int32
// truncation toward zero and the negative lerp weight w - (wl - 400) are
// the reference's (digital_earth_tpu/ops/spectral.py:129).
__device__ __forceinline__ float srgb_to_spectrum(const float* __restrict__ lut,
                                                  const float rgb[3], float wavelength) {
  const float wl = wavelength - 400.0f;
  const int w = (int)wl;
  const bool in_range = (w > 0) && (w < 299);
  const int wi = min(max(w, 0), 298);
  const int wj = min(wi + 1, 299);
  const float f = (float)w - wl;
  float coeff[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo = lut[3 * wi + c], hi = lut[3 * wj + c];
    coeff[c] = lo + (hi - lo) * f;
  }
  const float power = rgb[0] * coeff[0] + rgb[1] * coeff[1] + rgb[2] * coeff[2];
  return in_range ? power : 0.0f;
}

}  // namespace de
