"""Direction sampling as pure functions of uniform variates
(port of digital_earth_tpu/ops/sampling.py)."""

from __future__ import annotations

import math

import torch

from .math_utils import make_orthonormal_basis, normalize


def sample_cone(u0, u1, cos_theta_max):
    """Uniform direction in a +z cone."""
    cos_theta = (1.0 - u0) + u0 * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u1
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def sample_cone_oriented(u0, u1, cos_theta_max, n):
    """Uniform direction in a cone about axis ``n``."""
    local = sample_cone(u0, u1, cos_theta_max)
    x, y = make_orthonormal_basis(n)
    return local[..., 0:1] * x + local[..., 1:2] * y + local[..., 2:3] * n


def sample_hemisphere_cosine_weighted(u0, u1, n):
    """Cosine-weighted hemisphere about ``n`` (Shirley's offset sphere)."""
    a = 1.0 - 2.0 * u0
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
    a = a * (1.0 - 1e-5)
    b = b * (1.0 - 1e-5)
    phi = 2.0 * math.pi * u1
    v = torch.stack(
        [
            n[..., 0] + b * torch.cos(phi),
            n[..., 1] + b * torch.sin(phi),
            n[..., 2] + a,
        ],
        dim=-1,
    )
    return normalize(v)


def sample_sphere(u0, u1):
    """Uniform direction on the sphere."""
    ang = u0 * 2.0 * math.pi
    y = u1 * 2.0 - 1.0
    ground = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    return normalize(
        torch.stack([torch.sin(ang) * ground, torch.cos(ang) * ground, y], dim=-1)
    )
