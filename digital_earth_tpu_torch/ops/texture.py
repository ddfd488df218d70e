"""Equirectangular texture sampling (port of digital_earth_tpu/ops/texture.py:154-233).

A texture is a plain uint8 ``(H, W, C)`` tensor; a texel reads as value/255.
The JAX package's row-gather layout (``Tex2D``) is a TPU gather trick and is
not carried over: ``convert.tex2d_to_tensor`` unpacks it.

Conventions kept from the reference: texel centres at (i + 0.5)/N, u wraps,
v clamps, row 0 is the NORTH pole (``v`` from ``sphere_uv_map`` is 0 at the
south pole, so rows are addressed with 1 - v). Nearest taps round half to
even (``jnp.round``); bilinear is an explicit float32 lerp.
"""

from __future__ import annotations

import math

import torch

from .math_utils import normalize, sphere_uv_map


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
