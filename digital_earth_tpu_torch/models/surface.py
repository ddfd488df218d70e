"""Earth surface BRDF (port of digital_earth_tpu/models/surface.py:138):
Disney diffuse + land GGX / ocean Beckmann-GGX blend."""

from __future__ import annotations

import math

import torch

from ..ops.math_utils import dot, mix, normalize, rdiv, saturate, smoothstep, sqr

DIFFUSE_FACTOR = 0.28
SPECULAR_FACTOR = 0.5

LAND_ROUGHNESS = 0.73
LAND_F0 = 0.04
OCEAN_F0 = 0.02


def disney_diffuse(roughness, n_dot_l, n_dot_v, l_dot_h):
    r_r = 2.0 * roughness * sqr(l_dot_h)
    f_l = torch.pow(1.0 - n_dot_l, 5.0)
    f_v = torch.pow(1.0 - n_dot_v, 5.0)
    f_lambert = 1.0 / math.pi
    f_retro = f_lambert * r_r * (f_l + f_v + f_l * f_v * (r_r - 1.0))
    return f_lambert * (1.0 - 0.5 * f_l) * (1.0 - 0.5 * f_v) + f_retro


def ggx_d(n_dot_h, alpha2):
    den = (alpha2 - 1.0) * n_dot_h * n_dot_h + 1.0
    if isinstance(alpha2, float):
        return rdiv(alpha2, math.pi * den * den)
    return alpha2 / (math.pi * den * den)


def lambda_smith(n_dot_x, alpha2):
    n_dot_x2 = torch.clamp(n_dot_x * n_dot_x, min=1e-12)
    return (-1.0 + torch.sqrt(alpha2 * (1.0 - n_dot_x2) / n_dot_x2 + 1.0)) * 0.5


def g2_smith(n_dot_l, n_dot_v, alpha2):
    return 1.0 / (1.0 + lambda_smith(n_dot_v, alpha2) + lambda_smith(n_dot_l, alpha2))


def fresnel_dielectric(v_dot_h, f0):
    """Exact dielectric Fresnel parameterized by F0 (a Python float; the
    reference takes its sqrt in float32)."""
    eta = torch.sqrt(torch.tensor(f0, dtype=torch.float32, device=v_dot_h.device))
    eta = (1.0 + eta) / (1.0 - eta)
    sin_theta_i = torch.sqrt(saturate(1.0 - sqr(v_dot_h)))
    sin_theta_t = sin_theta_i / torch.clamp(eta, min=1e-8)
    cos_theta_t = torch.sqrt(torch.clamp(1.0 - sqr(sin_theta_t), min=0.0))
    r_s = sqr(
        (v_dot_h - eta * cos_theta_t)
        / torch.clamp(v_dot_h + eta * cos_theta_t, min=1e-8)
    )
    r_p = sqr(
        (cos_theta_t - eta * v_dot_h)
        / torch.clamp(cos_theta_t + eta * v_dot_h, min=1e-8)
    )
    return saturate((r_s + r_p) * 0.5)


def ggx_smith_specular(roughness, f0, n_dot_l, n_dot_v, l_dot_h, n_dot_h):
    alpha2 = roughness * roughness
    d = ggx_d(n_dot_h, alpha2)
    g = g2_smith(n_dot_l, n_dot_v, alpha2)
    f = fresnel_dielectric(l_dot_h, f0)
    return d * g * f / torch.clamp(4.0 * n_dot_l * n_dot_v, min=1e-5)


def beckmann_isotropic_ndf(n_dot_h, alpha):
    cos_theta2 = torch.clamp(n_dot_h * n_dot_h, min=1e-12)
    alpha2 = alpha * alpha
    exponent = (1.0 - cos_theta2) / (alpha2 * cos_theta2)
    denom = math.pi * alpha2 * cos_theta2 * cos_theta2
    return torch.exp(-exponent) / torch.clamp(denom, min=1e-5)


def g2_vcavity(n_dot_l, n_dot_v, n_dot_h, v_dot_h):
    v_dot_h = torch.clamp(v_dot_h, min=1e-8)
    return torch.clamp(
        torch.minimum(
            2.0 * n_dot_v * n_dot_h / v_dot_h, 2.0 * n_dot_l * n_dot_h / v_dot_h
        ),
        max=1.0,
    )


def beckmann_specular(roughness, f0, n_dot_l, n_dot_v, l_dot_h, n_dot_h):
    alpha = roughness * roughness * 2.0
    d = beckmann_isotropic_ndf(n_dot_h, alpha)
    v = g2_vcavity(n_dot_l, n_dot_v, n_dot_h, l_dot_h)
    f = fresnel_dielectric(l_dot_h, f0)
    return d * v * f


def earth_brdf_parts(oceanness, bathymetry, v, n, l):
    """Albedo-independent decomposition: (diffuse_term, specular_term,
    n_dot_l) with brdf = albedo * diffuse_term + specular_term."""
    h = normalize(v + l)
    n_dot_l = saturate(dot(n, l))
    n_dot_v = saturate(dot(n, v))
    l_dot_h = saturate(dot(l, h))
    n_dot_h = saturate(dot(n, h))

    ocean_roughness = mix(0.23 + 0.02, 0.23 - 0.04, smoothstep(0.3, 0.7, bathymetry))
    diffuse = disney_diffuse(LAND_ROUGHNESS, n_dot_l, n_dot_v, l_dot_h)
    land_specular = ggx_smith_specular(
        LAND_ROUGHNESS, LAND_F0, n_dot_l, n_dot_v, l_dot_h, n_dot_h
    )
    ocean_specular_ggx = ggx_smith_specular(
        ocean_roughness, OCEAN_F0, n_dot_l, n_dot_v, l_dot_h, n_dot_h
    )
    ocean_specular_beckmann = 0.65 * beckmann_specular(
        ocean_roughness, OCEAN_F0, n_dot_l, n_dot_v, l_dot_h, n_dot_h
    )
    ocean_specular = mix(
        ocean_specular_beckmann,
        ocean_specular_ggx,
        torch.clamp(smoothstep(0.2, 0.95, n_dot_v), 0.05, 0.94),
    )
    specular_blender = smoothstep(0.6, 1.0, oceanness)
    specular = mix(land_specular, ocean_specular, specular_blender) * SPECULAR_FACTOR
    return diffuse * DIFFUSE_FACTOR, specular, n_dot_l
