"""HDR -> SDR film chain (port of digital_earth_tpu/render/film.py:237-469):
OpenDRT (default) and AgX display transforms, measured camera response,
vignette, exposure, gamma, sRGB encode. The gamut and AgX matrices are
derived in numpy exactly as the reference derives them."""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..ops.math_utils import mix, saturate
from ..ops.spectral import lum3, srgb_transfer

LP = 100.0
GB = 0.12
CONTRAST = 1.0
FL = 0.005
RW = 0.25
BW = 0.35
DCH = 0.35
DCH_TOE = 0.0
HS_R = 0.3
HS_G = -0.1
HS_B = -0.2
V_P = 0.5

_WHITE_D65 = (0.3127, 0.3290)

_CAT02 = np.array(
    [
        [0.7328, 0.4296, -0.1624],
        [-0.7036, 1.6975, 0.0061],
        [0.0030, 0.0136, 0.9834],
    ]
)


def _xy_to_xyz(xy):
    x, y = xy
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def _rgb_to_xyz_from_chromaticities(r, g, b, w):
    prim = np.stack([_xy_to_xyz(r), _xy_to_xyz(g), _xy_to_xyz(b)], axis=1)
    scale = np.linalg.solve(prim, _xy_to_xyz(w))
    return prim * scale[None, :]


_REC709 = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06), _WHITE_D65)


@lru_cache(maxsize=None)
def _rec709_matrices():
    """(RGB->XYZ, XYZ->display) for the compiled Rec.709 in/out config."""
    to_xyz = _rgb_to_xyz_from_chromaticities(*_REC709).astype(np.float32)
    to_display = np.linalg.inv(to_xyz.astype(np.float64)).astype(np.float32)
    return to_xyz, to_display


def _mat(m, like):
    return torch.as_tensor(m, dtype=torch.float32, device=like.device)


def _sdiv(a, b):
    """Safe divide: 0 where |b| < 1e-4."""
    small = torch.abs(b) < 1e-4
    return torch.where(small, 0.0, a / torch.where(small, 1.0, b))


def _spow(a, b):
    """Safe power: passthrough for a <= 0."""
    return torch.where(a <= 0.0, a, torch.pow(torch.clamp(a, min=1e-12), b))


def _flare_scalar(x, fl):
    return (x + math.sqrt(x * (4.0 * fl + x))) / 2.0


@lru_cache(maxsize=None)
def _drt_constants(lp: float):
    """Tonescale intersection constants and display scale for the linear
    EOTF at peak luminance ``lp``."""
    ds = 100.0 / lp
    px = 128.0 * math.log10(lp) / math.log10(100.0) - 64.0
    py = lp / 100.0
    gx = 0.18
    gy = 11.696 / 100.0 * (1.0 + GB * math.log2(py))
    s0 = _flare_scalar(gy, FL)
    m0 = _flare_scalar(py, FL)
    ip = 1.0 / CONTRAST
    s = (px * gx * (m0**ip - s0**ip)) / (px * s0**ip - gx * m0**ip)
    m = m0**ip * (s + px) / px
    clamp_max = ds * lp / 100.0
    return m, s, ds, clamp_max


def _narrow_hue_angles(v):
    r = torch.clamp(v[..., 0] - (v[..., 1] + v[..., 2]), 0.0, 2.0)
    g = torch.clamp(v[..., 1] - (v[..., 0] + v[..., 2]), 0.0, 2.0)
    b = torch.clamp(v[..., 2] - (v[..., 0] + v[..., 1]), 0.0, 2.0)
    return torch.stack([r, g, b], dim=-1)


def opendrt_transform(rgb):
    """OpenDRT v0.2.2 HDR -> SDR in the reference's compiled configuration
    (Rec.709 in and out, linear EOTF, Lp = 100 nits)."""
    m_, s_, ds_, clamp_max = _drt_constants(LP)
    to_xyz, to_display = _rec709_matrices()
    rgb = rgb @ _mat(to_xyz, rgb).T
    rgb = rgb @ _mat(to_display, rgb).T

    mx = torch.amax(rgb, dim=-1)
    mn = torch.amin(rgb, dim=-1)
    h_rgb = _narrow_hue_angles(_sdiv(rgb - mn[..., None], mx[..., None]))

    w = np.array([RW, 1.0, BW], dtype=np.float32)
    w = w / np.linalg.norm(w)
    wrgb = _mat(w, rgb) * torch.clamp(rgb, min=1e-5)
    lum = torch.sqrt(
        wrgb[..., 0] * wrgb[..., 0] + wrgb[..., 1] * wrgb[..., 1]
        + wrgb[..., 2] * wrgb[..., 2]
    )
    rats = _sdiv(rgb, lum[..., None])

    ts = _spow(m_ * lum / (lum + s_), CONTRAST)
    ts = _spow(ts, 2.0) / (ts + FL)
    ts = ts * ds_

    dch_s = DCH / s_
    ccf = _sdiv(torch.ones_like(lum), lum * dch_s + 1.0)
    toe_ccf = (DCH_TOE + 1.0) * _sdiv(lum, lum + DCH_TOE) * ccf

    hs_w = (1.0 - ccf)[..., None] * h_rgb
    rats = torch.stack(
        [
            rats[..., 0] + hs_w[..., 2] * HS_B - hs_w[..., 1] * HS_G,
            rats[..., 1] + hs_w[..., 0] * HS_R - hs_w[..., 2] * HS_B,
            rats[..., 2] + hs_w[..., 1] * HS_G - hs_w[..., 0] * HS_R,
        ],
        dim=-1,
    )
    rats = 1.0 - toe_ccf[..., None] + rats * toe_ccf[..., None]
    rats = torch.clamp(rats, min=0.0)

    rats_mx = torch.amax(rats, dim=-1)
    rats_mn = torch.amin(rats, dim=-1)
    rats_ch = _sdiv(rats_mx - rats_mn, rats_mx)
    chf = _spow(rats_ch * ts, V_P)
    rats_n = _sdiv(rats, rats_mx[..., None])
    rats = rats_n * chf[..., None] + rats * (1.0 - chf[..., None])

    rgb = rats * ts[..., None]
    return torch.clamp(rgb, max=clamp_max)


# ---------------------------------------------------------------------------
# AgX
# ---------------------------------------------------------------------------

AGX_MIDDLE_GREY = 0.18
AGX_SLOPE = 2.3
AGX_TOE_POWER = 1.9
AGX_SHOULDER_POWER = 3.1
AGX_COMPRESSION = 0.15
AGX_MIN_EV = -10.0
AGX_MAX_EV = 6.5
AGX_SATURATION = 1.4


def _primaries_to_matrix(xy_r, xy_g, xy_b, xy_w):
    xyz_r, xyz_g, xyz_b = _xy_to_xyz(xy_r), _xy_to_xyz(xy_g), _xy_to_xyz(xy_b)
    xyz_w = _xy_to_xyz(xy_w)
    temp = np.array(
        [
            [xyz_r[0], xyz_g[0], xyz_b[0]],
            [1.0, 1.0, 1.0],
            [xyz_r[2], xyz_g[2], xyz_b[2]],
        ]
    )
    scale = np.linalg.inv(temp) @ xyz_w
    return np.array(
        [
            [scale[0] * xyz_r[0], scale[1] * xyz_g[0], scale[2] * xyz_b[0]],
            [scale[0] * xyz_r[1], scale[1] * xyz_g[1], scale[2] * xyz_b[1]],
            [scale[0] * xyz_r[2], scale[1] * xyz_g[2], scale[2] * xyz_b[2]],
        ]
    )


def _compression_matrix(xy_r, xy_g, xy_b, xy_w, compression):
    s = 1.0 / (1.0 - compression)
    f = lambda xy: tuple((np.asarray(xy) - np.asarray(xy_w)) * s + np.asarray(xy_w))  # noqa: E731
    return _primaries_to_matrix(f(xy_r), f(xy_g), f(xy_b), xy_w)


_AGX_SRGB_TO_XYZ = _primaries_to_matrix(*_REC709).astype(np.float32)
_AGX_XYZ_TO_ADJ = np.linalg.inv(
    _compression_matrix(*_REC709, AGX_COMPRESSION)
).astype(np.float32)


def _agx_scale(x_pivot, y_pivot, slope_pivot, power):
    a = torch.pow(slope_pivot * x_pivot, -power)
    b = torch.pow(slope_pivot * (x_pivot / y_pivot), power) - 1.0
    return torch.pow(a * b, -1.0 / power)


def _agx_hyperbolic(x, power):
    return x / torch.pow(1.0 + torch.pow(torch.abs(x), power), 1.0 / power)


def _agx_full_curve(x, x_pivot, y_pivot, slope_pivot, toe_power, shoulder_power):
    above = x >= x_pivot
    sxp = torch.where(above, 1.0 - x_pivot, x_pivot)
    syp = torch.where(above, 1.0 - y_pivot, y_pivot)
    toe_scale = _agx_scale(sxp, syp, slope_pivot, toe_power)
    shoulder_scale = _agx_scale(sxp, syp, slope_pivot, shoulder_power)
    scale = torch.where(above, shoulder_scale, -toe_scale)
    power = torch.where(above, shoulder_power, toe_power)
    term = (slope_pivot * (x - x_pivot)) / scale
    return scale * _agx_hyperbolic(term, power) + y_pivot


def agx_transform(rgb):
    """AgX HDR Rec.709 -> LDR."""
    xyz = rgb @ _mat(_AGX_SRGB_TO_XYZ, rgb).T
    adjusted = xyz @ _mat(_AGX_XYZ_TO_ADJ, rgb).T
    x_pivot = abs(AGX_MIN_EV) / (AGX_MAX_EV - AGX_MIN_EV)
    log_v = torch.clamp(
        torch.log2(torch.clamp(adjusted, min=1e-10) / AGX_MIDDLE_GREY),
        AGX_MIN_EV, AGX_MAX_EV,
    )
    log_v = (log_v - AGX_MIN_EV) / (AGX_MAX_EV - AGX_MIN_EV)
    out = _agx_full_curve(
        log_v, x_pivot, 0.5, AGX_SLOPE, AGX_TOE_POWER, AGX_SHOULDER_POWER
    )
    out = saturate(out)
    out = mix(lum3(out), out, AGX_SATURATION)
    return saturate(out)


# ---------------------------------------------------------------------------
# Camera response and the full chain
# ---------------------------------------------------------------------------


def camera_response(crf_curves, crf_index: int, tristimulus):
    """Per-channel 1D film-response LUT; crf_curves (1024, n_films, 3)."""
    res = crf_curves.shape[0]
    curve = crf_curves[:, crf_index]  # (1024, 3)
    t = saturate(tristimulus)
    u_offset = 0.5 / res
    u = torch.clamp(t + u_offset, max=1.0 - u_offset)
    x = u * res - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, res - 1)
    x1 = torch.clamp(x0 + 1, 0, res - 1)
    frac = x - x0.to(torch.float32)
    ch = torch.arange(3, device=x.device)
    v0 = curve[x0, ch]
    v1 = curve[x1, ch]
    return saturate(v0 * (1.0 - frac) + v1 * frac)


VIGNETTE_STRENGTH = 0.9
VIGNETTE_RADIUS = 0.0
VIGNETTE_CENTER = (0.5, 0.5)


def postprocess(
    color_buffer, spp, exposure: float, gamma: float, crf_curves,
    crf_index: int, drt: str = "opendrt",
):
    """color_buffer (W, H, 3) accumulated linear RGB -> display sRGB in
    [0, 1]: /spp, vignette, 2^exposure, DRT, camera response, gamma, sRGB.
    ``spp`` is a count or a (W, H, 1) per-pixel count tensor."""
    w, h = color_buffer.shape[:2]
    dev = color_buffer.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[:, None] / w
    v = torch.arange(h, dtype=torch.float32, device=dev)[None, :] / h
    darken = 1.0 - VIGNETTE_STRENGTH * torch.clamp(
        torch.sqrt((u - VIGNETTE_CENTER[0]) ** 2 + (v - VIGNETTE_CENTER[1]) ** 2)
        - VIGNETTE_RADIUS,
        min=0.0,
    )
    spp = torch.clamp(torch.as_tensor(spp, dtype=torch.float32, device=dev), min=1.0)
    exposure_scale = torch.pow(
        torch.tensor(2.0, device=dev), torch.tensor(exposure, dtype=torch.float32, device=dev)
    )
    linear = color_buffer / spp * darken[..., None] * exposure_scale
    if drt == "opendrt":
        tonemapped = opendrt_transform(linear)
    elif drt == "agx":
        tonemapped = agx_transform(linear)
    elif drt == "none":
        tonemapped = linear
    else:
        raise ValueError(f"unknown display transform {drt!r}")
    cam = camera_response(crf_curves, crf_index, tonemapped)
    graded = torch.pow(
        torch.clamp(cam, min=0.0), torch.tensor(gamma, dtype=torch.float32, device=dev)
    )
    return saturate(srgb_transfer(graded))
