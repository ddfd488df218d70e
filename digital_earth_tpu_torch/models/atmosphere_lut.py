"""Semi-analytic atmosphere integrals (port of
digital_earth_tpu/models/atmosphere_lut.py): the density-integral table,
its lookups, and the monotone density envelopes behind the local
delta-tracking majorant.

``_build_table`` is the reference's numpy build, copied so the port never
imports the JAX module; it is held in memory for the life of the process
and converted to a device tensor once per device (``density_table``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import constants as C

from ..ops.math_utils import dot, length
from . import volume as vol

R_TOP = float(C.ATMOS_UPPER_LIMIT)
R_LO = float(C.PLANET_R) - 8e3
N_RP = 384
N_X = 1024
_BUILD_SUBSTEPS = 16
_N_DEEP = 120
_D_MIN = 0.5e3
_LOG_RATIO = float(np.log(R_LO / _D_MIN))


def _np_densities(h):
    """float64 twins of the closed-form density profiles for the table build."""
    rayl = 3.68082 * np.exp(-((h + 24239.99) ** 2) / 532307548.4168) / 1.225
    d_high = 0.0918 * np.exp(-1.0e-6 * (h - 11500.0) ** 2)
    d_mid = 0.3000 * np.exp(-2.5e-9 * (h + 2500.0) ** 2) - 0.092
    d_low = 0.6500 * np.exp(-5.0e-6 * (h - 1300.0) ** 2) + 0.18899
    d_ground = 1.0 - h / 8136.646
    mie = np.where(
        h > 11500.0,
        d_high,
        np.where(h > 2400.0, d_mid, np.where(h > 1300.0, d_low, d_ground)),
    ) * float(C.TURBIDITY)
    h_km = h * 0.001
    rel2 = (h_km - float(C.OZONE_PEAK_HEIGHT) * 0.001) ** 2
    o3 = (
        (1.0 - 0.375) * np.exp(-rel2 / 49.0)
        + 0.375 * np.exp(-rel2 / 256.0)
        + np.maximum(0.0, -0.000015 * (h_km - 15.0) ** 3)
    )
    return rayl, mie, o3


@lru_cache(maxsize=1)
def _build_table() -> np.ndarray:
    """(N_RP, N_X, 3) float32 cumulative per-species density integrals
    F_c(rp_i, x_j) by fine trapezoid quadrature (float64 accumulation)."""
    i = np.arange(N_RP, dtype=np.float64)
    shell = R_LO + (i - _N_DEEP) / (N_RP - 1 - _N_DEEP) * (R_TOP - R_LO)
    t = (_N_DEEP - i) / _N_DEEP
    rp = np.where(i < _N_DEEP, R_LO - _D_MIN * np.exp(t * _LOG_RATIO), shell)
    x_lo = np.sqrt(np.maximum(R_LO * R_LO - rp * rp, 0.0))
    x_hi = np.sqrt(np.maximum(R_TOP * R_TOP - rp * rp, 0.0))
    n_fine = (N_X - 1) * _BUILD_SUBSTEPS + 1
    frac = np.linspace(0.0, 1.0, n_fine)
    xs = x_lo[:, None] + (x_hi - x_lo)[:, None] * frac[None, :]
    r = np.sqrt(rp[:, None] ** 2 + xs**2)
    h = np.maximum(r - C.PLANET_R, 0.0)
    rho = np.stack(_np_densities(h), axis=-1)
    dx = ((x_hi - x_lo) / (n_fine - 1))[:, None, None]
    cells = 0.5 * (rho[:, 1:] + rho[:, :-1]) * dx
    f_fine = np.concatenate(
        [np.zeros((N_RP, 1, 3)), np.cumsum(cells, axis=1)], axis=1
    )
    return np.ascontiguousarray(f_fine[:, ::_BUILD_SUBSTEPS].astype(np.float32))


_TABLES: dict = {}


def density_table(device) -> torch.Tensor:
    """The (N_RP, N_X, 3) table on ``device`` (one copy per device)."""
    key = str(torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(_build_table()).to(device)
    return _TABLES[key]


def _lerp(v0, v1, w):
    return v0 * (1.0 - w) + v1 * w


def _index_to_rp(i):
    """Row index (int tensor) -> perigee radius."""
    i = i.to(torch.float32)
    shell = R_LO + (i - _N_DEEP) / (N_RP - 1 - _N_DEEP) * (R_TOP - R_LO)
    t = (_N_DEEP - i) / _N_DEEP
    deep = R_LO - _D_MIN * torch.exp(t * _LOG_RATIO)
    return torch.where(i < _N_DEEP, deep, shell)


def _rp_to_index(rp):
    """Perigee radius -> continuous row index."""
    shell_idx = _N_DEEP + (rp - R_LO) / (R_TOP - R_LO) * (N_RP - 1 - _N_DEEP)
    depth = torch.clamp(R_LO - rp, _D_MIN, R_LO)
    deep_idx = _N_DEEP * (1.0 - torch.log(depth / _D_MIN) / _LOG_RATIO)
    return torch.clamp(
        torch.where(
            rp < R_LO - _D_MIN, deep_idx, torch.clamp(shell_idx, min=_N_DEEP)
        ),
        0.0,
        N_RP - 1.0,
    )


def _row_x_bounds(rp):
    x_lo = torch.sqrt(torch.clamp(R_LO * R_LO - rp * rp, min=0.0))
    x_hi = torch.sqrt(torch.clamp(R_TOP * R_TOP - rp * rp, min=0.0))
    return x_lo, x_hi


def _f_eval(table, rp, x_abs):
    """Bilinear F(rp, |x|) -> (..., 3), interpolated across perigee rows at
    equal radius (xi^2 = x^2 + (rp - rp_i)(rp + rp_i))."""
    i_f = _rp_to_index(rp)
    i0 = torch.clamp(torch.floor(i_f).to(torch.int64), 0, N_RP - 2)
    wi = (i_f - i0.to(i_f.dtype))[..., None]

    def row_val(i):
        rp_i = _index_to_rp(i)
        xi = torch.sqrt(
            torch.clamp(x_abs * x_abs + (rp - rp_i) * (rp + rp_i), min=0.0)
        )
        x_lo, x_hi = _row_x_bounds(rp_i)
        u = torch.clamp(
            (xi - x_lo) / torch.clamp(x_hi - x_lo, min=1.0), 0.0, 1.0
        ) * (N_X - 1)
        j0 = torch.clamp(torch.floor(u).to(torch.int64), 0, N_X - 2)
        wj = (u - j0.to(u.dtype))[..., None]
        return _lerp(table[i, j0], table[i, j0 + 1], wj)

    return _lerp(row_val(i0), row_val(i0 + 1), wi)


def _f_tot(table, rp):
    """F(rp, x_hi) -> (..., 3): the full-row integral, linear in rp."""
    i_f = _rp_to_index(rp)
    i0 = torch.clamp(torch.floor(i_f).to(torch.int64), 0, N_RP - 2)
    wi = (i_f - i0.to(i_f.dtype))[..., None]
    return _lerp(table[i0, -1], table[i0 + 1, -1], wi)


def _fma(a, b, c):
    """float32 a * b + c with one rounding (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _ray_perigee(pos, direction):
    """(rp, x0): perigee radius (from the cross product, stable in float32)
    and the signed distance of ``pos`` from the perigee along the ray.

    The reference's ``jnp.cross`` is compiled with its multiply-adds fused,
    and the cross product here rounds the same way: rp's float32 ulp is
    0.5 m at planet scale, and a grazing density integral moves by 1e-4 to
    8e-4 of itself per metre of rp (the 8 km and 1.2 km scale heights)."""
    p0, p1, p2 = pos[..., 0], pos[..., 1], pos[..., 2]
    d0, d1, d2 = direction[..., 0], direction[..., 1], direction[..., 2]
    cr = torch.stack(
        [_fma(p1, d2, -(p2 * d1)), _fma(p2, d0, -(p0 * d2)), _fma(p0, d1, -(p1 * d0))],
        dim=-1,
    )
    rp = length(cr)
    x0 = dot(pos, direction)
    return rp, x0


def density_integral_to_space(pos, direction):
    """(..., 3) per-species density integrals from ``pos`` to the top of the
    atmosphere (the ray must not hit the planet)."""
    table = density_table(pos.device)
    rp, x0 = _ray_perigee(pos, direction)
    f_end = _f_tot(table, rp)
    f0 = torch.sign(x0)[..., None] * _f_eval(table, rp, torch.abs(x0))
    return torch.clamp(f_end - f0, min=0.0)


def density_integral_segment(pos, direction, t0, t1):
    """(..., 3) per-species density integrals over ray parameter [t0, t1]."""
    table = density_table(pos.device)
    rp, xp = _ray_perigee(pos, direction)
    x0 = t0 + xp
    x1 = t1 + xp
    f0 = torch.sign(x0)[..., None] * _f_eval(table, rp, torch.abs(x0))
    f1 = torch.sign(x1)[..., None] * _f_eval(table, rp, torch.abs(x1))
    return torch.clamp(f1 - f0, min=0.0)


def rmo_transmittance_to_space(ext_rmo, pos, direction):
    """Exact per-wavelength RMO transmittance exp(-sum_c k_c D_c) from
    ``pos`` to space. ext_rmo (n, L, 3) -> (n, L)."""
    d = density_integral_to_space(pos, direction)
    tau = dot(ext_rmo, d[:, None, :])
    return torch.exp(-tau)


# ---------------------------------------------------------------------------
# Monotone density envelopes for local delta-tracking majorants
# ---------------------------------------------------------------------------

# The reference evaluates its jnp profile on float64 numpy input, which JAX
# casts to float32: the same float32 evaluation here.
_O3_ENV_PEAK = float(
    vol.get_ozone_density(
        torch.from_numpy(np.linspace(0.0, 60e3, 4096)).to(torch.float32)
    ).max()
)
_MIE_ENV_PLATEAU = 0.0918 * float(C.TURBIDITY)
_ENV_SAFETY_M = 8.0


def density_envelope(h):
    """(..., 3) per-species envelopes env_c(h) >= rho_c(h') for all h' >= h."""
    h = torch.clamp(h - _ENV_SAFETY_M, min=0.0)
    env_r = vol.get_rayl_density(h)
    env_m = torch.maximum(
        vol.get_mie_density(h),
        torch.where(h <= 11500.0, _MIE_ENV_PLATEAU, 0.0),
    )
    env_o = torch.where(
        h < C.OZONE_PEAK_HEIGHT, _O3_ENV_PEAK, vol.get_ozone_density(h)
    )
    return torch.stack([env_r, env_m, env_o], dim=-1)


def segment_min_radius(rp, x_t, x_e):
    """Minimum radius over the perigee-frame sub-segment [x_t, x_e]."""
    spans = (x_t < 0.0) & (x_e > 0.0)
    end_min = torch.sqrt(rp * rp + torch.minimum(x_t * x_t, x_e * x_e))
    return torch.where(spans, rp, end_min)
