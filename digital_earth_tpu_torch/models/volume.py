"""Atmospheric volume models (port of digital_earth_tpu/models/volume.py):
phase functions and samplers, spectral extinctions, density profiles."""

from __future__ import annotations

import math

import torch

from .. import constants as C

from ..ops.math_utils import (
    dot, length, make_orthonormal_basis, rdiv, spherical_direction, sqr,
)
from ..ops.sampling import sample_sphere


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def air_ior(wavelength_um):
    rcp_wl_sqr = 1.0 / (wavelength_um * wavelength_um)
    return (
        1.0
        + 8.06051e-5
        + rdiv(2.480990e-2, 132.274 - rcp_wl_sqr)
        + rdiv(1.74557e-4, 39.32957 - rcp_wl_sqr)
    )


# ---------------------------------------------------------------------------
# Phase functions (cos_theta = dir . light)
# ---------------------------------------------------------------------------


def rayleigh_phase(cos_theta):
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_theta * cos_theta)


def klein_nishina_phase(cos_theta, e):
    log_term = torch.log(_f32(2.0 * e + 1.0, cos_theta))
    return rdiv(e, 2.0 * math.pi * (e * (1.0 - cos_theta) + 1.0) * log_term)


def mie_phase(cos_theta):
    return klein_nishina_phase(cos_theta, C.MIE_ASYMMETRY)


def hg_phase(cos_theta, g):
    return (1.0 - g * g) / (
        4.0 * math.pi * torch.pow(1.0 + g * g - 2.0 * g * cos_theta, 1.5)
    )


def draine_phase(cos_theta, g, a):
    return ((1.0 - g * g) * (1.0 + a * cos_theta * cos_theta)) / (
        4.0
        * (1.0 + (a * (1.0 + 2.0 * g * g)) / 3.0)
        * math.pi
        * torch.pow(1.0 + g * g - 2.0 * g * cos_theta, 1.5)
    )


_D = C.CLOUD_DROPLET_SIZE
CLOUD_G_HG_FULL = math.exp(-0.0990567 / (_D - 1.67154))
CLOUD_G_HG_REDUCED = 0.91
CLOUD_G_DRAINE = math.exp(-2.20679 / (_D + 3.91029) - 0.428934)
CLOUD_ALPHA_DRAINE = math.exp(3.62489 - 8.29288 / (_D + 5.52825))
CLOUD_W_DRAINE = math.exp(-0.599085 / (_D - 0.641583) - 0.665888)


def _cloud_g_hg(reduce_peak: bool, like):
    """The HG asymmetry as a float32 scalar: the reference selects it with a
    traced ``jnp.where``, so its derived terms round in float32."""
    return _f32(CLOUD_G_HG_REDUCED if reduce_peak else CLOUD_G_HG_FULL, like)


def cloud_phase(cos_theta, reduce_peak: bool):
    """HG + Draine mixture for cloud droplets; ``reduce_peak`` selects the
    multi-scatter 0.91 HG peak."""
    g_hg = _cloud_g_hg(reduce_peak, cos_theta)
    return (
        hg_phase(cos_theta, g_hg) * (1.0 - CLOUD_W_DRAINE)
        + draine_phase(cos_theta, CLOUD_G_DRAINE, CLOUD_ALPHA_DRAINE)
        * CLOUD_W_DRAINE
    )


# ---------------------------------------------------------------------------
# Phase samplers — pure functions of uniform variates.
# ---------------------------------------------------------------------------


def _direction_about(view, cos_theta, u_phi):
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u_phi
    tang, bitang = make_orthonormal_basis(view)
    return spherical_direction(sin_theta, cos_theta, phi, tang, bitang, view)


def sample_hg_cos(u, g):
    sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
    return (1.0 + g * g - sqr_term * sqr_term) / (2.0 * g)


def sample_klein_nishina_cos(u, e):
    return (-torch.pow(2.0 * e + 1.0, 1.0 - u) + e + 1.0) / e


def sample_draine_cos(u, g, a):
    """Exact Draine inverse-CDF cos(theta) (Jendersie & d'Eon 2023)."""
    g2 = g * g
    g3 = g * g2
    g4 = g2 * g2
    g6 = g2 * g4
    pgp1_2 = (1.0 + g2) * (1.0 + g2)
    t1a = -a + a * g4
    t1a3 = t1a * t1a * t1a
    t2 = -1296.0 * (-1.0 + g2) * (a - a * g2) * t1a * (4.0 * g2 + a * pgp1_2)
    t3 = 3.0 * g2 * (1.0 + g * (-1.0 + 2.0 * u)) + a * (
        2.0 + g2 + g3 * (1.0 + 2.0 * g2) * (-1.0 + 2.0 * u)
    )
    t4a = 432.0 * t1a3 + t2 + 432.0 * (a - a * g2) * t3 * t3
    t4b = -144.0 * a * g2 + 288.0 * a * g4 - 144.0 * a * g6
    t4b3 = t4b * t4b * t4b
    t4 = t4a + torch.sqrt(torch.clamp(-4.0 * t4b3 + t4a * t4a, min=0.0))
    t4p3 = torch.pow(t4, 1.0 / 3.0)
    cbrt2 = 2.0 ** (1.0 / 3.0)
    t6 = (
        2.0 * t1a
        + rdiv(48.0 * cbrt2 * (-(a * g2) + 2.0 * a * g4 - a * g6), t4p3)
        + t4p3 / (3.0 * cbrt2)
    ) / (a - a * g2)
    t5 = 6.0 * (1.0 + g2) + t6
    cos_theta = (
        1.0
        + g2
        - torch.pow(
            -0.5 * torch.sqrt(torch.clamp(t5, min=0.0))
            + torch.sqrt(
                torch.clamp(
                    6.0 * (1.0 + g2)
                    - (8.0 * t3)
                    / (a * (-1.0 + g2) * torch.sqrt(torch.clamp(t5, min=1e-20)))
                    - t6,
                    min=0.0,
                )
            )
            / 2.0,
            2.0,
        )
    ) / (2.0 * g)
    return torch.clamp(cos_theta, -1.0, 1.0)


def sample_cloud_phase(u_mix, u0, u1, view, reduce_peak: bool):
    """Mixture sampler for the cloud phase; ``u_mix`` picks the lobe."""
    g_hg = _cloud_g_hg(reduce_peak, u0)
    cos_draine = sample_draine_cos(u0, CLOUD_G_DRAINE, CLOUD_ALPHA_DRAINE)
    cos_hg = sample_hg_cos(u0, g_hg)
    cos_theta = torch.where(u_mix < CLOUD_W_DRAINE, cos_draine, cos_hg)
    return _direction_about(view, cos_theta, u1)


def sample_phase_dirs(u_mix, u0, u1, view, interaction_id, reduce_peak: bool):
    """Phase sampling for all interaction species at once, selected per lane.
    Returns (direction, phase_div_pdf)."""
    sphere_dir = sample_sphere(u0, u1)
    mie_dir = _direction_about(
        view, sample_klein_nishina_cos(u0, C.MIE_ASYMMETRY), u1
    )
    cloud_dir = sample_cloud_phase(u_mix, u0, u1, view, reduce_peak)

    is_rayleigh = interaction_id == C.RAYLEIGH_ID
    is_iso = interaction_id == C.ISOTROPIC_CLOUD_ID
    is_mie = interaction_id == C.MIE_ID
    uniform = is_rayleigh | is_iso

    direction = torch.where(
        uniform[..., None], sphere_dir,
        torch.where(is_mie[..., None], mie_dir, cloud_dir),
    )
    cos_theta = dot(view, sphere_dir)
    iso_phase = 1.0 / (4.0 * math.pi)
    uni_phase = torch.where(is_iso, iso_phase, rayleigh_phase(cos_theta))
    phase_div_pdf = torch.where(uniform, uni_phase * (4.0 * math.pi), 1.0)
    return direction, phase_div_pdf


def evaluate_phase(ray_dir, light_dir, interaction_id, reduce_peak: bool):
    """Phase value toward ``light_dir`` per lane."""
    cos_theta = dot(ray_dir, light_dir)
    return torch.where(
        interaction_id == C.RAYLEIGH_ID,
        rayleigh_phase(cos_theta),
        torch.where(
            interaction_id == C.MIE_ID,
            mie_phase(cos_theta),
            torch.where(
                interaction_id == C.CLOUD_ID,
                cloud_phase(cos_theta, reduce_peak),
                torch.where(
                    interaction_id == C.ISOTROPIC_CLOUD_ID,
                    1.0 / (4.0 * math.pi),
                    0.0,
                ),
            ),
        ),
    )


# ---------------------------------------------------------------------------
# Spectral extinction coefficients (wavelength in nm)
# ---------------------------------------------------------------------------


def spectra_extinction_mie(wavelength):
    """Junge/turbidity aerosol extinction."""
    junge = 4.0
    c = (0.6544 * C.TURBIDITY - 0.6510) * 4e-18
    k = (0.773335 - 0.00386891 * wavelength) / (1.0 - 0.00546759 * wavelength)
    return (
        0.434 * c * math.pi
        * torch.pow(rdiv(2.0 * math.pi, wavelength * 1e-9), junge - 2.0)
        * k
    )


def spectra_extinction_rayleigh(wavelength):
    """Rayleigh extinction from the air IOR + King depolarization factor."""
    wavelength_m = wavelength * 1e-9
    f_n2 = 1.034 + rdiv(3.17e-4, sqr(wavelength))
    f_o2 = (
        1.096 + rdiv(1.385e-3, sqr(wavelength))
        + rdiv(1.448e-4, sqr(sqr(wavelength)))
    )
    cco2 = 0.0421
    king_factor = (78.084 * f_n2 + 20.946 * f_o2 + 0.934 + cco2 * 1.15) / (
        78.084 + 20.946 + 0.934 + cco2
    )
    n = sqr(air_ior(wavelength * 1e-3)) - 1.0
    return (
        (8.0 * math.pi**3 * sqr(n))
        / (3.0 * C.AIR_NUM_DENSITY * torch.pow(wavelength_m, 4.0))
    ) * king_factor


def spectra_extinction_ozone(wavelength, o3_crossec_lut):
    """Ozone absorption from the measured cross-section LUT, 390-831 nm."""
    idx = torch.clamp(
        (wavelength - 390.0).to(torch.int32), 0, o3_crossec_lut.shape[0] - 1
    ).to(torch.int64)
    in_range = (wavelength >= 390.0) & (wavelength < 831.0)
    return torch.where(
        in_range, 1e-4 * C.OZONE_NUM_DENSITY * o3_crossec_lut[idx], 0.0
    )


# ---------------------------------------------------------------------------
# Density profiles (h = elevation above sea level in meters)
# ---------------------------------------------------------------------------


def get_ozone_density(h):
    h_km = h * 0.001
    rel = h_km - C.OZONE_PEAK_HEIGHT * 0.001
    rel2 = rel * rel
    d = (1.0 - 0.375) * torch.exp(-rel2 / 49.0)
    d = d + 0.375 * torch.exp(-rel2 / 256.0)
    c = h_km - 15.0
    d = d + torch.clamp(-0.000015 * (c * c * c), min=0.0)
    return d


def get_rayl_density(h):
    density_sea_level = 1.225
    return 3.68082 * torch.exp(-sqr(h + 24239.99) / 532307548.4168) / density_sea_level


def get_mie_density(h):
    d_high = 0.0918 * torch.exp(-1.0e-6 * sqr(h - 11500.0))
    d_mid = 0.3000 * torch.exp(-2.5e-9 * sqr(h + 2500.0)) - 0.092
    d_low = 0.6500 * torch.exp(-5.0e-6 * sqr(h - 1300.0)) + 0.18899
    d_ground = 1.0 - h / 8136.646
    dens = torch.where(
        h > 11500.0,
        d_high,
        torch.where(h > 2400.0, d_mid, torch.where(h > 1300.0, d_low, d_ground)),
    )
    return dens * C.TURBIDITY


def get_density(h):
    """(rayleigh, mie, ozone) densities, elevation clamped at 0."""
    h = torch.clamp(h, min=0.0)
    return torch.stack(
        [get_rayl_density(h), get_mie_density(h), get_ozone_density(h)], dim=-1
    )


def get_elevation(pos):
    """Elevation above the sphere of radius PLANET_R."""
    return length(pos) - C.PLANET_R
