"""Spectral colour machinery (port of digital_earth_tpu/ops/spectral.py):
blackbody SPDs, hero-wavelength sampling, sRGB -> spectrum, sRGB transfer."""

from __future__ import annotations

import numpy as np
import torch

from .math_utils import dot, ipow, matvec3, mix, rdiv, saturate

XYZ_TO_RGB_D65 = np.array(
    [
        [3.2409699419, -1.5373831776, -0.4986107603],
        [-0.9692436363, 1.8759675015, 0.0415550574],
        [0.0556300797, -0.2039769589, 1.0569715142],
    ],
    dtype=np.float32,
)
LUM_WEIGHTS = np.array([0.2126729, 0.7151522, 0.0721750], dtype=np.float32)


def _const(a, like):
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def xyz_to_rgb(xyz):
    """XYZ -> linear sRGB, trailing axis of size 3."""
    return matvec3(_const(XYZ_TO_RGB_D65, xyz), xyz)


PLANCK_H, PLANCK_C, PLANCK_K = 6.62607015e-16, 2.9e17, 1.38e-5  # nm-scaled


def planck_kernel_constants():
    """The kernels' float32 (2 h c^2, h c, k) of ``plancks``."""
    h, c, k = PLANCK_H, PLANCK_C, PLANCK_K
    return [float(np.float32(x)) for x in (2.0 * h * c * c, h * c, k)]


def plancks(temperature, wavelength):
    """Blackbody SPD with nm-scaled constants; ``wavelength`` in nm."""
    h, c, k = PLANCK_H, PLANCK_C, PLANCK_K
    p1 = rdiv(2.0 * h * c * c, ipow(wavelength, 5))
    p2 = torch.exp(rdiv(h * c, wavelength * k * temperature)) - 1.0
    return p1 / p2


def cie_g(cie_cdf):
    """The scalar CDF the inversion searches: saturate(mean of channels)."""
    return saturate(cie_cdf.mean(dim=-1)).contiguous()


def _cie_mid(u, g):
    """Texture coordinate of the inverse CDF at ``u`` (``searchsorted``
    side="left", index clipped to [1, res - 1])."""
    res = g.shape[0]
    idx = torch.clamp(torch.searchsorted(g, u.contiguous(), right=False), 1, res - 1)
    g0 = g[idx - 1]
    g1 = g[idx]
    frac = torch.where(g1 > g0, (u - g0) / torch.clamp(g1 - g0, min=1e-12), 0.5)
    return ((idx - 1).to(torch.float32) + 0.5 + saturate(frac)) / res


def _cie_response(mids, cie_response):
    """Bilinear fetch of the XYZ response row at texture coordinate ``mids``."""
    res = cie_response.shape[0]
    x = mids * res - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, res - 1)
    x1 = torch.clamp(x0 + 1, 0, res - 1)
    t = (x - x0.to(torch.float32))[..., None]
    return cie_response[x0] * (1.0 - t) + cie_response[x1] * t


def spectrum_sample(u, cie_cdf, cie_response):
    """One wavelength by CIE inverse-CDF (the preview's sampler,
    digital_earth_tpu/ops/spectral.py:42). Returns (wavelength (...),
    response (..., 3), rcp_pdf (...))."""
    mid = _cie_mid(u, cie_g(cie_cdf))
    wavelength = 390.0 + 441.0 * mid
    response = _cie_response(mid, cie_response)
    pdf = dot(response, cie_cdf[cie_cdf.shape[0] - 1])
    ok = (pdf > 1e-3) & torch.isfinite(pdf)
    rcp_pdf = torch.where(ok, rdiv(1.0, torch.clamp(pdf, min=1e-12)), 0.0)
    return wavelength, response, rcp_pdf


def hero_shifts(n_lambdas: int, device=None):
    """The packet's rotations, ``arange(L) * float32(1 / L)``: the jitted
    reference's rounding (XLA turns its ``arange(L) / L`` into a multiply by
    the float32 reciprocal; eager JAX divides, and parts from it by one ulp
    at L = 6, 7, 12, ...), on every device, as csrc/gen_rays.cu takes it
    (ROADMAP C #6)."""
    rcp = float(torch.tensor(1.0, dtype=torch.float32) / n_lambdas)
    return torch.arange(n_lambdas, dtype=torch.float32, device=device) * rcp


def spectrum_sample_hero(u, cie_cdf, cie_response, n_lambdas: int = 4):
    """Hero-wavelength packet (Wilkie et al. 2014): the hero by CIE
    inverse-CDF (``searchsorted`` side="left"), companions at equal spectral
    rotations. Returns (wavelengths (..., L), responses (..., L, 3),
    lambda_pdf (..., L))."""
    res = cie_cdf.shape[0]
    mid = _cie_mid(u, cie_g(cie_cdf))
    mids = torch.remainder(mid[..., None] + hero_shifts(n_lambdas, u.device), 1.0)
    wavelengths = 390.0 + 441.0 * mids
    responses = _cie_response(mids, cie_response)

    pdf = dot(responses, cie_cdf[res - 1])
    ok = (pdf > 1e-3) & torch.isfinite(pdf)
    lambda_pdf = torch.where(ok, pdf, 0.0)
    return wavelengths, responses, lambda_pdf


def srgb_to_spectrum(lut, rgb, wavelength):
    """Spectral power of an sRGB triple via the 300-bin (400-700 nm) basis,
    with the reference's int32 truncation toward zero and its negative
    interpolation weight ``f = w - (wavelength - 400)`` kept verbatim."""
    wl = wavelength - 400.0
    w = wl.to(torch.int32)
    in_range = (w > 0) & (w < 299)
    wi = torch.clamp(w, 0, 298).to(torch.int64)
    f = (w.to(torch.float32) - wl)[..., None]
    coeff = mix(lut[wi], lut[torch.clamp(wi + 1, 0, 299)], f)
    power = dot(rgb, coeff)
    return torch.where(in_range, power, 0.0)


def srgb_transfer(linear):
    """Linear -> sRGB OETF."""
    lo = linear * 12.92
    hi = torch.pow(torch.abs(linear), 1.0 / 2.4) * 1.055 - 0.055
    return torch.where(linear < 0.0031308, lo, hi)


def lum(x):
    """Rec.709 luminance."""
    return dot(x, _const(LUM_WEIGHTS, x))


def lum3(x):
    y = lum(x)
    return torch.stack([y, y, y], dim=-1)
