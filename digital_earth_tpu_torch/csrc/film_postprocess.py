"""film_postprocess: the per-pixel display chain as one Triton kernel.

Replaces digital_earth_tpu/render/film.py:438 postprocess with
opendrt_transform (:237), agx_transform (:387) and camera_response (:411):
/spp (a scalar or a per-pixel count), vignette, 2^exposure, the display
transform, the film's response curve, gamma and the sRGB encode.

What bounds it on the H100: memory. Each pixel reads 12 bytes (16 with a
per-pixel count) and six taps of one 12 KiB column of the response table,
and writes 12 bytes; there is no reuse between pixels, so the kernel is one
masked pass over the flat pixels with everything in registers, in place of
the plain version's ~150 element-wise launches and their (W, H, 3)
temporaries. The display transform is a ``tl.constexpr`` (0 OpenDRT, 1 AgX,
2 none) and its two 3x3 matrices are compile-time scalars.

This file imports ``triton``; ``digital_earth_tpu_torch.kernels`` loads it
from its path when a CUDA tensor first reaches the film, so nothing imports
it on a machine without Triton.
"""

import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def _sdiv(a, b):
    small = tl.abs(b) < 1e-4
    return tl.where(small, 0.0, a / tl.where(small, 1.0, b))


@triton.jit
def _sat(x):
    return tl.minimum(tl.maximum(x, 0.0), 1.0)


@triton.jit
def _mat3(x, y, z, m00: tl.constexpr, m01: tl.constexpr, m02: tl.constexpr,
          m10: tl.constexpr, m11: tl.constexpr, m12: tl.constexpr,
          m20: tl.constexpr, m21: tl.constexpr, m22: tl.constexpr):
    return (x * m00 + y * m01 + z * m02, x * m10 + y * m11 + z * m12,
            x * m20 + y * m21 + z * m22)


@triton.jit
def _agx_scale(xp, yp, power: tl.constexpr):
    a = libdevice.pow(2.3 * xp, -power)
    b = libdevice.pow(2.3 * (xp / yp), power) - 1.0
    return libdevice.pow(a * b, -1.0 / power)


@triton.jit
def _agx_curve(adjusted):
    """AgX log encoding and the toe/shoulder curve of one channel."""
    x_pivot = 10.0 / 16.5
    log_v = libdevice.log2(tl.maximum(adjusted, 1e-10) / 0.18)
    log_v = tl.minimum(tl.maximum(log_v, -10.0), 6.5)
    x = (log_v + 10.0) / 16.5
    above = x >= x_pivot
    sxp = tl.where(above, 1.0 - x_pivot, x_pivot)
    toe_scale = _agx_scale(sxp, 0.5, 1.9)
    shoulder_scale = _agx_scale(sxp, 0.5, 3.1)
    scale = tl.where(above, shoulder_scale, -toe_scale)
    power = tl.where(above, 3.1, 1.9)
    term = (2.3 * (x - x_pivot)) / scale
    hyper = term / libdevice.pow(1.0 + libdevice.pow(tl.abs(term), power), 1.0 / power)
    return scale * hyper + 0.5


@triton.jit
def _response(x, crf_ptr, ch: tl.constexpr, crf_index, n_films, mask, RES: tl.constexpr):
    """Camera response of one channel: lerp of its curve, saturated."""
    t = _sat(x)
    u = tl.minimum(t + 0.5 / RES, 1.0 - 0.5 / RES)
    xx = u * RES - 0.5
    x0 = tl.minimum(tl.maximum(libdevice.floor(xx).to(tl.int32), 0), RES - 1)
    x1 = tl.minimum(x0 + 1, RES - 1)
    frac = xx - x0.to(tl.float32)
    v0 = tl.load(crf_ptr + (x0 * n_films + crf_index) * 3 + ch, mask=mask, other=0.0)
    v1 = tl.load(crf_ptr + (x1 * n_films + crf_index) * 3 + ch, mask=mask, other=0.0)
    return _sat(v0 * (1.0 - frac) + v1 * frac)


@triton.jit
def _encode(cam, gamma):
    graded = libdevice.pow(tl.maximum(cam, 0.0), gamma)
    hi = libdevice.pow(tl.abs(graded), 1.0 / 2.4) * 1.055 - 0.055
    return _sat(tl.where(graded < 0.0031308, graded * 12.92, hi))


@triton.jit
def film_postprocess_kernel(
    buf_ptr, count_ptr, crf_ptr, out_ptr, n_pix, w, h, spp, exposure_scale,
    gamma, crf_index, n_films,
    A00: tl.constexpr, A01: tl.constexpr, A02: tl.constexpr,
    A10: tl.constexpr, A11: tl.constexpr, A12: tl.constexpr,
    A20: tl.constexpr, A21: tl.constexpr, A22: tl.constexpr,
    B00: tl.constexpr, B01: tl.constexpr, B02: tl.constexpr,
    B10: tl.constexpr, B11: tl.constexpr, B12: tl.constexpr,
    B20: tl.constexpr, B21: tl.constexpr, B22: tl.constexpr,
    DRT_M: tl.constexpr, DRT_S: tl.constexpr, DRT_DS: tl.constexpr,
    DRT_CLAMP: tl.constexpr, DCH_S: tl.constexpr,
    LW0: tl.constexpr, LW1: tl.constexpr, LW2: tl.constexpr,
    DRT: tl.constexpr, HAS_COUNT: tl.constexpr, CRF_RES: tl.constexpr,
    BLOCK: tl.constexpr,
):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n_pix
    r = tl.load(buf_ptr + offs * 3, mask=mask, other=0.0)
    g = tl.load(buf_ptr + offs * 3 + 1, mask=mask, other=0.0)
    b = tl.load(buf_ptr + offs * 3 + 2, mask=mask, other=0.0)

    # /spp, vignette (strength 0.9, radius 0, centre (0.5, 0.5)), exposure
    u = (offs // h).to(tl.float32) / w
    v = (offs % h).to(tl.float32) / h
    darken = 1.0 - 0.9 * tl.maximum(tl.sqrt_rn((u - 0.5) * (u - 0.5) + (v - 0.5) * (v - 0.5)), 0.0)
    if HAS_COUNT:
        s = tl.maximum(tl.load(count_ptr + offs, mask=mask, other=1.0), 1.0)
    else:
        s = spp
    r = r / s * darken * exposure_scale
    g = g / s * darken * exposure_scale
    b = b / s * darken * exposure_scale

    if DRT == 0:  # OpenDRT, Rec.709 in and out, linear EOTF, Lp = 100
        r, g, b = _mat3(r, g, b, A00, A01, A02, A10, A11, A12, A20, A21, A22)
        r, g, b = _mat3(r, g, b, B00, B01, B02, B10, B11, B12, B20, B21, B22)
        mx = tl.maximum(tl.maximum(r, g), b)
        mn = tl.minimum(tl.minimum(r, g), b)
        hr = _sdiv(r - mn, mx)
        hg = _sdiv(g - mn, mx)
        hb = _sdiv(b - mn, mx)
        nr = tl.minimum(tl.maximum(hr - (hg + hb), 0.0), 2.0)
        ng = tl.minimum(tl.maximum(hg - (hr + hb), 0.0), 2.0)
        nb = tl.minimum(tl.maximum(hb - (hr + hg), 0.0), 2.0)
        wr = LW0 * tl.maximum(r, 1e-5)
        wg = LW1 * tl.maximum(g, 1e-5)
        wb = LW2 * tl.maximum(b, 1e-5)
        lum = tl.sqrt_rn(wr * wr + wg * wg + wb * wb)
        rr = _sdiv(r, lum)
        rg = _sdiv(g, lum)
        rb = _sdiv(b, lum)
        ts = DRT_M * lum / (lum + DRT_S)
        ts = tl.where(ts <= 0.0, ts, tl.maximum(ts, 1e-12))  # pow(., contrast 1)
        tsq = tl.maximum(ts, 1e-12)
        ts = tl.where(ts <= 0.0, ts, tsq * tsq) / (ts + 0.005)  # flare 0.005
        ts = ts * DRT_DS
        ccf = _sdiv(1.0, lum * DCH_S + 1.0)
        toe_ccf = 1.0 * _sdiv(lum, lum + 0.0) * ccf
        hw = 1.0 - ccf
        hsr = hw * nr
        hsg = hw * ng
        hsb = hw * nb
        xr = rr + hsb * -0.2 - hsg * -0.1
        xg = rg + hsr * 0.3 - hsb * -0.2
        xb = rb + hsg * -0.1 - hsr * 0.3
        xr = tl.maximum(1.0 - toe_ccf + xr * toe_ccf, 0.0)
        xg = tl.maximum(1.0 - toe_ccf + xg * toe_ccf, 0.0)
        xb = tl.maximum(1.0 - toe_ccf + xb * toe_ccf, 0.0)
        rmx = tl.maximum(tl.maximum(xr, xg), xb)
        rmn = tl.minimum(tl.minimum(xr, xg), xb)
        rch = _sdiv(rmx - rmn, rmx) * ts
        chf = tl.where(rch <= 0.0, rch, tl.sqrt_rn(tl.maximum(rch, 1e-12)))  # pow(., 0.5)
        xr = _sdiv(xr, rmx) * chf + xr * (1.0 - chf)
        xg = _sdiv(xg, rmx) * chf + xg * (1.0 - chf)
        xb = _sdiv(xb, rmx) * chf + xb * (1.0 - chf)
        r = tl.minimum(xr * ts, DRT_CLAMP)
        g = tl.minimum(xg * ts, DRT_CLAMP)
        b = tl.minimum(xb * ts, DRT_CLAMP)
    elif DRT == 1:  # AgX
        r, g, b = _mat3(r, g, b, A00, A01, A02, A10, A11, A12, A20, A21, A22)
        r, g, b = _mat3(r, g, b, B00, B01, B02, B10, B11, B12, B20, B21, B22)
        r = _sat(_agx_curve(r))
        g = _sat(_agx_curve(g))
        b = _sat(_agx_curve(b))
        lum = r * 0.2126729 + g * 0.7151522 + b * 0.0721750
        r = _sat(lum + (r - lum) * 1.4)
        g = _sat(lum + (g - lum) * 1.4)
        b = _sat(lum + (b - lum) * 1.4)

    r = _encode(_response(r, crf_ptr, 0, crf_index, n_films, mask, CRF_RES), gamma)
    g = _encode(_response(g, crf_ptr, 1, crf_index, n_films, mask, CRF_RES), gamma)
    b = _encode(_response(b, crf_ptr, 2, crf_index, n_films, mask, CRF_RES), gamma)
    tl.store(out_ptr + offs * 3, r, mask=mask)
    tl.store(out_ptr + offs * 3 + 1, g, mask=mask)
    tl.store(out_ptr + offs * 3 + 2, b, mask=mask)
