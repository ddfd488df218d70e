"""Per-lane counter-based RNG: JAX's threefry2x32 key chain, bit for bit
(port of digital_earth_tpu/ops/rng.py:33-64).

Every draw of the path tracer is keyed by the chain
(spp key -> global pixel id -> bounce -> site -> loop iteration), built from
``fold`` and ``uniform``. This module reproduces ``jax.random.fold_in`` and
``jax.random.uniform`` under ``jax_threefry_partitionable=True`` exactly, so
the port and the reference draw the same stream in every lane (common random
numbers). The CUDA kernels carry the same generator in
``csrc/threefry.cuh``.

Keys are ``(..., 2)`` int64 tensors holding uint32 values: torch's uint32
support is partial, so the arithmetic runs in int64 masked to 32 bits.

- ``fold(key, d)`` = threefry2x32(key; (0, d)) — ``fold_in`` hashes the
  seed pair (d >> 32, d & 0xffffffff) of a 32-bit datum.
- ``uniform(key, shape)`` element with flat index j = the float built from
  the 32-bit word y0 ^ y1, (y0, y1) = threefry2x32(key; (0, j)), as
  ``((bits >> 9) | 0x3F800000) - 1`` — JAX's partitionable random bits.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, as ``jax._src.prng`` applies it.
    All arguments are int64 tensors (or ints) holding uint32 values."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & M32
    return x0, x1


def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): (2,) key."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def _as_u32(data, like):
    if isinstance(data, torch.Tensor):
        return data.to(torch.int64) & M32
    return torch.tensor(int(data) & M32, dtype=torch.int64, device=like.device)


def fold(keys, data):
    """``jax.random.fold_in`` of a scalar or per-lane datum into every key
    of a (..., 2) batch."""
    d = _as_u32(data, keys)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def lane_keys(key, lane_ids):
    """(n, 2) per-lane keys: ``fold_in(key, id)`` for every lane id."""
    return fold(key[None, :], lane_ids)


def as_lane_keys(key_or_keys, n: int):
    """One (2,) key expanded over ``arange(n)`` lane ids, or an existing
    (n, 2) key batch."""
    k = key_or_keys
    if k.ndim == 1:
        return lane_keys(k, torch.arange(n, device=k.device))
    if tuple(k.shape) != (n, 2):
        raise ValueError(f"lane keys of shape {tuple(k.shape)}, expected ({n}, 2)")
    return k


def bits_to_uniform(bits):
    """uint32 words (int64 tensor) -> float32 in [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(keys, shape=()):
    """Per-lane uniforms: (n, 2) keys -> (*shape, n) draws (lane axis last,
    the (draws, k, n) layout the tracking loops consume)."""
    total = math.prod(shape)
    idx = torch.arange(total, dtype=torch.int64, device=keys.device)[:, None]
    y0, y1 = threefry2x32(
        keys[None, :, 0], keys[None, :, 1], torch.zeros_like(idx), idx
    )
    u = bits_to_uniform(y0 ^ y1)  # (total, n)
    return u.reshape(tuple(shape) + (keys.shape[0],))
