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


def plancks(temperature, wavelength):
    """Blackbody SPD with nm-scaled constants; ``wavelength`` in nm."""
    h = 6.62607015e-16
    c = 2.9e17
    k = 1.38e-5
    p1 = rdiv(2.0 * h * c * c, ipow(wavelength, 5))
    p2 = torch.exp(rdiv(h * c, wavelength * k * temperature)) - 1.0
    return p1 / p2


def spectrum_sample_hero(u, cie_cdf, cie_response, n_lambdas: int = 4):
    """Hero-wavelength packet (Wilkie et al. 2014): the hero by CIE
    inverse-CDF (``searchsorted`` side="left"), companions at equal spectral
    rotations. Returns (wavelengths (..., L), responses (..., L, 3),
    lambda_pdf (..., L))."""
    res = cie_cdf.shape[0]
    g = saturate(cie_cdf.mean(dim=-1)).contiguous()
    idx = torch.clamp(torch.searchsorted(g, u.contiguous(), right=False), 1, res - 1)
    g0 = g[idx - 1]
    g1 = g[idx]
    frac = torch.where(g1 > g0, (u - g0) / torch.clamp(g1 - g0, min=1e-12), 0.5)
    mid = ((idx - 1).to(torch.float32) + 0.5 + saturate(frac)) / res

    shifts = torch.arange(n_lambdas, dtype=torch.float32, device=u.device) / n_lambdas
    mids = torch.remainder(mid[..., None] + shifts, 1.0)
    wavelengths = 390.0 + 441.0 * mids

    x = mids * res - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, res - 1)
    x1 = torch.clamp(x0 + 1, 0, res - 1)
    t = (x - x0.to(torch.float32))[..., None]
    responses = cie_response[x0] * (1.0 - t) + cie_response[x1] * t

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
