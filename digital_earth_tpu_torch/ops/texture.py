"""Equirectangular texture sampling (port of digital_earth_tpu/ops/texture.py:154-233)
and the device upsample of the tier-2 atlas (``Tex2D.from_upsampled``, :74-148).

A texture is a plain uint8 ``(H, W, C)`` tensor; a texel reads as value/255.
The JAX package's row-gather layout (``Tex2D``) is a TPU gather trick and is
not carried over: ``convert.tex2d_to_tensor`` unpacks it. ``upsample`` is
the wrapper of the CUDA kernel ``upsample`` (csrc/upsample.cu),
``upsample_plain`` its plain twin.

Conventions kept from the reference: texel centres at (i + 0.5)/N, u wraps,
v clamps, row 0 is the NORTH pole (``v`` from ``sphere_uv_map`` is 0 at the
south pole, so rows are addressed with 1 - v). Nearest taps round half to
even (``jnp.round``); bilinear is an explicit float32 lerp.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .math_utils import normalize, sphere_uv_map


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32): the constant in 16-bit
    halves, so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _lowbias32(x):
    """The lowbias32 hash (Walker 2018) of uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def upsample_plain(base, factor: int, jitter: float = 0.0, jitter_channel: int = 0,
                   jitter_seed: int = 0x9E3779B9):
    """Nearest-neighbour upsample of a uint8 (h, w[, C]) image by an integer
    ``factor`` to (h f, w f, C): the image of ``Tex2D.from_upsampled``
    (digital_earth_tpu/ops/texture.py:74-148), bit for bit.

    With ``jitter`` > 0, channel ``jitter_channel`` of output texel
    t = y W + x becomes rint(v * (1 - jitter * u)) in float32 (round half to
    even), u = float32(lowbias32(t ^ seed)) * 2^-32: the reference's hash of
    the same texel id, which it computes on its packed lanes."""
    if base.dim() == 2:
        base = base[:, :, None]
    h, w, c = base.shape
    f = int(factor)
    H, W = h * f, w * f
    out = torch.empty((H, W, c), dtype=torch.uint8, device=base.device)
    out.view(h, f, w, f, c).copy_(base[:, None, :, None, :])
    if jitter > 0.0 and 0 <= jitter_channel < c:
        ids = torch.arange(H * W, dtype=torch.int64, device=base.device) & 0xFFFFFFFF
        u = _lowbias32(ids ^ (jitter_seed & 0xFFFFFFFF)).to(torch.float32) * 2.0**-32
        del ids
        j = float(torch.tensor(jitter, dtype=torch.float32))
        ch = out[..., jitter_channel]
        ch.copy_(torch.round(ch.to(torch.float32) * (1.0 - j * u.view(H, W))))
    return out


def upsample(base, factor: int, jitter: float = 0.0, jitter_channel: int = 0,
             jitter_seed: int = 0x9E3779B9):
    """``upsample_plain``'s function: the CUDA kernel ``upsample``
    (csrc/upsample.cu) for a CUDA tensor, the plain version for a CPU one."""
    if base.dim() == 2:
        base = base[:, :, None]
    if base.device.type == "cpu":
        return upsample_plain(base, factor, jitter, jitter_channel, jitter_seed)
    return kernels.upsample(base, factor, jitter, jitter_channel, jitter_seed)


def fetch_texel(tex, iy, ix):
    """Texel (iy, ix) -> (..., C) float32 in [0, 1]."""
    return tex[iy, ix].to(torch.float32) * (1.0 / 255.0)


def sample_equirect(tex, u, v, bilinear: bool = True):
    """Sample at (u, v) in [0, 1]^2. Returns (..., C), squeezed for C = 1."""
    h, w, c = tex.shape
    x = u * w - 0.5
    y = torch.clamp((1.0 - v) * h - 0.5, 0.0, h - 1.0)
    if bilinear:
        x0f = torch.floor(x)
        y0f = torch.floor(y)
        tx = (x - x0f)[..., None]
        ty = (y - y0f)[..., None]
        x0 = torch.remainder(x0f.to(torch.int64), w)
        x1 = torch.remainder(x0 + 1, w)
        y0 = torch.clamp(y0f.to(torch.int64), 0, h - 1)
        y1 = torch.clamp(y0 + 1, 0, h - 1)
        v00 = fetch_texel(tex, y0, x0)
        v10 = fetch_texel(tex, y0, x1)
        v01 = fetch_texel(tex, y1, x0)
        v11 = fetch_texel(tex, y1, x1)
        out = (v00 * (1 - tx) + v10 * tx) * (1 - ty) + (
            v01 * (1 - tx) + v11 * tx
        ) * ty
    else:
        x0 = torch.remainder(torch.round(x).to(torch.int64), w)
        y0 = torch.clamp(torch.round(y).to(torch.int64), 0, h - 1)
        out = fetch_texel(tex, y0, x0)
    if c == 1:
        out = out[..., 0]
    return out


def sample_sphere_texture(tex, pos, bilinear: bool = True):
    """Sample an equirect texture at the direction of ``pos``."""
    u, v = sphere_uv_map(normalize(pos))
    return sample_equirect(tex, u, v, bilinear=bilinear)


def sample_dir_texture(tex, direction, bilinear: bool = True):
    """Sample an equirect texture by unit direction (stars background),
    dividing the angles by pi as the reference and the ``frame_end`` kernel
    do, on the CPU and on the card alike."""
    pi = torch.tensor(math.pi, dtype=torch.float32, device=direction.device)
    u, v = sphere_uv_map(direction, pi)
    return sample_equirect(tex, u, v, bilinear=bilinear)
