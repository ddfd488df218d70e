"""Vectorized geometry/math primitives (port of digital_earth_tpu/ops/math_utils.py).

Vectors are tensors with a trailing axis of size 3. Everything rounds op
by op in float32, as the CUDA kernels do (built with ``--fmad=false``).

``rsi`` keeps the reference port's NaN fix (math_utils.py:71): a miss
returns (-1, -1), and the sqrt only ever sees a clamped discriminant
(``torch.where``, like ``jnp.where``, evaluates both branches).
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-4
INF = 1e10


def sqr(x):
    return x * x


def ipow(x, n: int):
    """x**n for a positive integer n by JAX's ``lax.integer_pow`` schedule
    (binary exponentiation), so the product rounds as in the reference."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def rdiv(a: float, x):
    """``a / x`` for a Python scalar ``a``: a true float32 division, as JAX
    rounds it (torch's ``a / x`` computes ``x.reciprocal() * a``)."""
    return torch.div(torch.tensor(a, dtype=x.dtype, device=x.device), x)


def dot(a, b):
    """Batched 3-vector dot product over the trailing axis, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def matvec3(m, x):
    """``x @ m.T`` for a (3, 3) matrix, each row a left-to-right dot."""
    return torch.stack([dot(x, m[r]) for r in range(3)], dim=-1)


def sum_last(x):
    """Sum over the trailing axis, left to right (XLA's CPU order)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    return v / torch.clamp(length(v)[..., None], min=1e-20)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0],
        dim=-1,
    )


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def mix(a, b, t):
    """GLSL mix: a + (b - a) * t (t may lie outside [0, 1])."""
    return a + (b - a) * t


def step(edge, x):
    return torch.where(x < edge, 0.0, 1.0).to(torch.float32)


def smoothstep(edge0, edge1, x):
    t = saturate((x - edge0) / (edge1 - edge0))
    return t * t * (3.0 - 2.0 * t)


def cone_angle_to_solid_angle(x):
    """Solid angle of a cone of half-angle x."""
    return 2.0 * math.pi * (1.0 - torch.cos(x))


def rsi(pos, direction, r):
    """Ray-sphere intersection with a sphere of radius ``r`` at the origin:
    ``(t_near, t_far)``, both -1 on a miss."""
    b = dot(pos, direction)
    c = dot(pos, pos) - r * r
    discr = b * b - c
    sq = torch.sqrt(torch.clamp(discr, min=0.0))
    miss = discr < 0.0
    t_near = torch.where(miss, -1.0, -b - sq)
    t_far = torch.where(miss, -1.0, -b + sq)
    return t_near, t_far


def sphere_uv_map(n, pi=math.pi):
    """Equirectangular UV from a unit direction. ``pi`` as a float32 tensor
    makes the division a true one on a CUDA tensor too (a Python scalar
    divisor is applied there as a multiply by its reciprocal)."""
    u = (torch.atan2(n[..., 2], -n[..., 0]) / pi + 1.0) / 2.0
    v = torch.asin(torch.clamp(n[..., 1], -1.0, 1.0)) / pi + 0.5
    return u, v


def make_orthonormal_basis(n):
    """Tangent/bitangent for a unit normal n."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    h = torch.where((torch.abs(n[..., 1]) > 0.9)[..., None], ex, ey)
    y = normalize(cross(n, h))
    x = cross(n, y)
    return x, y


def spherical_direction(sin_theta, cos_theta, phi, x, y, z):
    """Direction from spherical coordinates in the (x, y, z) frame."""
    return (
        (sin_theta * torch.cos(phi))[..., None] * x
        + (sin_theta * torch.sin(phi))[..., None] * y
        + cos_theta[..., None] * z
    )


def fract(x):
    return x - torch.floor(x)


def normal_distribution(x, mean, stdev):
    return (1.0 / (stdev * math.sqrt(2.0 * math.pi))) * torch.exp(
        -0.5 * sqr((x - mean) / stdev)
    )


def hash12(p):
    """Deterministic 2 -> 1 hash (reference math_utils.py:72-75)."""
    px, py = p[..., 0], p[..., 1]
    p3 = fract(torch.stack([px, py, px], dim=-1) * 0.1031)
    swiz = torch.stack([p3[..., 1], p3[..., 2], p3[..., 0]], dim=-1)
    p3 = p3 + dot(p3, swiz + 19.19)[..., None]
    return fract((p3[..., 0] + p3[..., 1]) * p3[..., 2])


def hash22(p):
    """Deterministic 2 -> 2 hash (reference math_utils.py:77-81)."""
    px, py = p[..., 0], p[..., 1]
    k = torch.tensor([0.1031, 0.1030, 0.0973], dtype=torch.float32, device=p.device)
    p3 = fract(torch.stack([px, py, px], dim=-1) * k)
    swiz = torch.stack([p3[..., 1], p3[..., 2], p3[..., 0]], dim=-1)
    p3 = p3 + dot(p3, swiz + 19.19)[..., None]
    return fract(
        torch.stack([p3[..., 0] + p3[..., 1], p3[..., 1] + p3[..., 2]], dim=-1)
        * torch.stack([p3[..., 2], p3[..., 1]], dim=-1)
    )


# Host-side (numpy) camera helpers, mirroring reference math_utils.py:83-102.


def np_normalize(v):
    return v / np.sqrt(np.sum(v**2))


def np_rotate_matrix(axis, theta):
    """4x4 rotation matrix about ``axis`` by ``theta`` radians (host side)."""
    axis = np_normalize(np.asarray(axis, dtype=np.float64))
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array(
        [
            [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac), 0],
            [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab), 0],
            [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc, 0],
            [0, 0, 0, 1],
        ]
    )
