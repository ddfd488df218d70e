"""Wavefront spectral volumetric path tracer, default configuration (port of
digital_earth_tpu/render/pathtracer.py).

One bounce of the reference's ``run_bounces`` body (pathtracer.py:1554-1924)
is ``run_bounce``; ``run_bounces`` applies it one bounce at a time to the
still-alive lanes only (a stable ``torch.nonzero`` gather before the bounce,
a scatter after it). A dead lane is a no-op in the reference's body, and
every random draw is keyed per lane, so the image does not depend on this
schedule. The three per-lane loops the bounce launches live in
``tracers.py`` with their CUDA kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch

from .. import constants as C

from ..models import atmosphere_lut as atm
from ..models import surface as srf
from ..models import volume as vol
from ..ops import math_utils as mu
from ..ops import rng
from ..ops import sampling as smp
from ..ops import spectral as sp
from ..ops import texture as tx
from .params import SceneParams, TraceConfig
from .tracers import (  # noqa: F401  (re-exported loop entry points)
    ABSORB_EVENT, NULL_EVENT, SCATTER_EVENT, _CLOUD_VALID, _MIP_VALID_COARSE,
    _MIP_VALID_FINE, delta_track_rmo, intersect_land, track_cloud,
)

# RNG site ids (pathtracer.py:62-71): lane key -> bounce -> site -> loop.
_SITE_FLIGHT = 1
_SITE_CONE = 2
_SITE_TRANS = 3
_SITE_PHASE = 4
_SITE_HEMI = 5
_SITE_RR = 6
_SUB_RMO = 1
_SUB_CLOUD = 2


def land_sdf(topo, pos, scale, bilinear=True):
    """Bump-mapped sphere SDF; channel 0 of ``topo`` is the height."""
    sample = tx.sample_sphere_texture(topo, pos, bilinear=bilinear)
    return mu.length(pos) - C.PLANET_R - scale * sample[..., 0]


def land_normal(topo, pos, scale, bilinear=True):
    """Finite-difference normal, 3 extra SDF taps (epsilon = pi R / W)."""
    d = land_sdf(topo, pos, scale, bilinear)
    e = math.pi * C.PLANET_R / topo.shape[1]
    eye = torch.eye(3, device=pos.device) * e
    n = torch.stack(
        [d - land_sdf(topo, pos - eye[a], scale, bilinear) for a in range(3)],
        dim=-1,
    )
    return mu.normalize(n)


def get_land_material(atlas, pos, bilinear=True):
    """Albedo grading from one packed 8-channel material tap: returns
    (albedo_srgb (n, 3), ocean, bathymetry, emissive)."""
    mat = tx.sample_sphere_texture(atlas.material, pos, bilinear=bilinear)
    albedo_texture_srgb = mat[..., 0:3]
    ocean = mat[..., 3]

    land_albedo = mu.mix(sp.lum3(albedo_texture_srgb), albedo_texture_srgb, 6.5)
    land_greenery = torch.pow(
        land_albedo[..., 1] / torch.clamp(sp.lum(land_albedo), min=1e-8), 2.0
    )
    land_greenery = mu.smoothstep(1.5, 1.9, land_greenery)
    land_albedo = albedo_texture_srgb / (land_greenery[..., None] * 0.7 + 1.0)
    land_albedo = mu.mix(
        sp.lum3(land_albedo), land_albedo, (1.4 - land_greenery * 0.45)[..., None]
    )
    warm = torch.tensor([255.0, 128.0, 64.0], device=pos.device) / 255.0
    land_albedo = mu.mix(
        land_albedo, land_albedo * warm, (0.2 * (1.0 - land_greenery))[..., None]
    )
    ocean_albedo = mu.mix(sp.lum3(albedo_texture_srgb), albedo_texture_srgb, 0.75) * 0.9
    albedo_srgb = mu.mix(land_albedo, ocean_albedo, ocean[..., None])
    return albedo_srgb, ocean, mat[..., 4], mat[..., 5]


def intersect_cloud_limits(ray_pos, ray_dir, land_isection):
    """Parametric span of the cloud slab along the ray."""
    r = mu.length(ray_pos)
    lo_n, lo_f = mu.rsi(ray_pos, ray_dir, C.CLOUDS_LOWER_LIMIT)
    up_n, up_f = mu.rsi(ray_pos, ray_dir, C.CLOUDS_UPPER_LIMIT)
    above = r >= C.CLOUDS_UPPER_LIMIT
    inside = (~above) & (r >= C.CLOUDS_LOWER_LIMIT)

    t_start_above = torch.clamp(up_n, min=0.0)
    t_max_above = torch.where(lo_f >= 0.0, lo_n, up_f)
    t_max_above = torch.where(up_f < 0.0, -1.0, t_max_above)
    t_max_inside = torch.where(lo_f >= 0.0, lo_n, up_f)
    t_max_below = torch.where(land_isection > 0.0, -1.0, up_f)

    t_start = torch.where(
        above, t_start_above, torch.where(inside, torch.zeros_like(r), lo_f)
    )
    t_max = torch.where(above, t_max_above, torch.where(inside, t_max_inside, t_max_below))
    return t_start, t_max


def _rmo_span(ray_pos, ray_dir, land_isection):
    """Atmosphere span clipped by the land hit."""
    a_near, a_far = mu.rsi(ray_pos, ray_dir, C.ATMOS_UPPER_LIMIT)
    t_start = torch.clamp(a_near, min=0.0)
    t_max = torch.where(land_isection >= 0.0, land_isection, a_far)
    t_max = torch.where(a_far < 0.0, -1.0, t_max)
    return t_start, t_max


def sample_interaction(keys, ray_pos, ray_dir, land_isection, ext_rmo, ext_w,
                       atlas, active, cfg: TraceConfig):
    """Cloud pass, then the RMO pass capped at the cloud event; the nearer
    event wins (pathtracer.py:1236). Returns (event, t, iid, c_event, c_t)."""
    k_rmo = rng.fold(keys, _SUB_RMO)
    k_cloud = rng.fold(keys, _SUB_CLOUD)
    t_start, t_max = _rmo_span(ray_pos, ray_dir, land_isection)
    c_start, c_max = intersect_cloud_limits(ray_pos, ray_dir, land_isection)
    c_event, c_t = track_cloud(
        k_cloud, ray_pos, ray_dir, c_start, c_max, ext_w, atlas.clouds,
        active, cfg, mode="delta",
    )
    # the RMO pass only needs to reach the cloud event
    rmo_cap = torch.where(c_event > NULL_EVENT, torch.minimum(t_max, c_t), t_max)
    rmo_event, rmo_t, rmo_id = delta_track_rmo(
        k_rmo, ray_pos, ray_dir, t_start, rmo_cap,
        ext_rmo[:, 0, :].contiguous(), active, cfg,
    )
    take_cloud = (c_event > NULL_EVENT) & (rmo_event == NULL_EVENT)
    event = torch.where(take_cloud, c_event, rmo_event)
    t = torch.where(take_cloud, c_t, rmo_t)
    iid = torch.where(take_cloud, C.CLOUD_ID, rmo_id).to(torch.int32)
    return event, t, iid, c_event, c_t


def sample_transmittance(keys, ray_pos, ray_dir, ext_rmo, ext_w, atlas,
                         active, cfg: TraceConfig):
    """Sun transmittance (n, L): the exact RMO closed form from the density
    table times cloud ratio tracking (pathtracer.py:1326)."""
    k_cloud = rng.fold(keys, _SUB_CLOUD)
    trans = atm.rmo_transmittance_to_space(ext_rmo, ray_pos, ray_dir)
    no_land = torch.full_like(ext_w, -1.0)
    c_start, c_max = intersect_cloud_limits(ray_pos, ray_dir, no_land)
    cloud_trans = track_cloud(
        k_cloud, ray_pos, ray_dir, c_start, c_max, ext_w, atlas.clouds,
        active, cfg, mode="ratio",
    )
    return trans * cloud_trans[:, None]


def spectral_flight_weights(ray_pos, ray_dir, t_start, t_end, extinctions,
                            iid, rmo_collision, active):
    """Closed-form hero-packet MIS weight of this bounce's flight outcome
    (pathtracer.py:786). Returns (n, L)."""
    t_end = torch.maximum(t_end, t_start)
    d_seg = atm.density_integral_segment(ray_pos, ray_dir, t_start, t_end)
    tau = mu.dot(extinctions, d_seg[:, None, :])
    w = torch.exp(-(tau - tau[:, :1]))
    k_sp = torch.gather(
        extinctions, 2,
        torch.clamp(iid, max=2).to(torch.int64)[:, None, None].expand(-1, extinctions.shape[1], 1),
    )[..., 0]
    sp_ratio = k_sp / torch.clamp(k_sp[:, :1], min=1e-20)
    w = torch.where(rmo_collision[:, None], w * sp_ratio, w)
    return torch.where(active[:, None], w, 1.0)


@dataclass
class TraceState:
    """Per-lane wavefront state (structure of arrays)."""

    pos: torch.Tensor          # (N, 3)
    direction: torch.Tensor    # (N, 3)
    wavelength: torch.Tensor   # (N, L)
    lambda_pdf: torch.Tensor   # (N, L)
    throughput: torch.Tensor   # (N, L)
    radiance: torch.Tensor     # (N, L)
    w_mis: torch.Tensor        # (N, L)
    alive: torch.Tensor        # (N,) bool
    primary_miss: torch.Tensor # (N,) bool
    rng: torch.Tensor          # (N, 2) int64 lane keys

    def take(self, idx) -> "TraceState":
        return TraceState(**{f.name: getattr(self, f.name)[idx] for f in fields(self)})

    def put(self, idx, sub: "TraceState"):
        for f in fields(self):
            getattr(self, f.name)[idx] = getattr(sub, f.name)


def init_state(ray_pos, ray_dir, wavelength, lambda_pdf, rng_keys) -> TraceState:
    n, L = wavelength.shape
    dev = ray_pos.device
    return TraceState(
        pos=ray_pos,
        direction=ray_dir,
        wavelength=wavelength,
        lambda_pdf=lambda_pdf,
        throughput=torch.ones((n, L), device=dev),
        radiance=torch.zeros((n, L), device=dev),
        w_mis=torch.ones((n, L), device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        primary_miss=torch.zeros((n,), dtype=torch.bool, device=dev),
        rng=rng_keys,
    )


def run_bounce(st: TraceState, bounce: int, scene: SceneParams, atlas, luts,
               cfg: TraceConfig) -> TraceState:
    """One bounce of every lane in ``st`` (all alive): the reference's
    ``run_bounces`` body at ``bounce`` (pathtracer.py:1554-1924)."""
    pos, direction = st.pos, st.direction
    wavelength, lambda_pdf = st.wavelength, st.lambda_pdf
    throughput, radiance, w_mis = st.throughput, st.radiance, st.w_mis
    alive = st.alive
    n, L = wavelength.shape
    dev = pos.device
    scale = scene.land_height_scale
    topo = atlas.topography

    sun_power = sp.plancks(C.SUN_TEMPERATURE, wavelength)
    nightlights_power = sp.plancks(C.NIGHTLIGHT_TEMPERATURE, wavelength) * C.NIGHTLIGHT_SCALE
    sun_irradiance = sun_power * mu.cone_angle_to_solid_angle(scene.sun_angular_radius)
    ext_rmo = torch.stack(
        [
            vol.spectra_extinction_rayleigh(wavelength),
            vol.spectra_extinction_mie(wavelength),
            vol.spectra_extinction_ozone(wavelength, luts.o3_crossec),
        ],
        dim=-1,
    )  # (n, L, 3)
    light_direction = scene.light_direction.expand(n, 3)

    ext_w_scalar = (
        C.MULTISCATTER_CLOUD_EXTINCT if bounce > C.MULTISCATTER_BOUNCE
        else C.CLOUDS_EXTINCT
    )
    ext_w = torch.full((n,), ext_w_scalar, device=dev)
    kb = rng.fold(st.rng, bounce)

    # March on demand: one topography tap at the origin certifies a
    # terrain-free ball; only lanes whose flight leaves it march.
    tap = tx.sample_sphere_texture(topo, pos, bilinear=False)
    r_len = mu.length(pos)
    d_free = torch.maximum(
        torch.maximum(
            torch.clamp(r_len - (C.PLANET_R + scale * tap[..., 1]), max=_MIP_VALID_FINE),
            torch.clamp(r_len - (C.PLANET_R + scale * tap[..., 2]), max=_MIP_VALID_COARSE),
        ),
        torch.clamp(r_len - (C.PLANET_R + scale * tap[..., 3]), max=_CLOUD_VALID),
    )
    base_near, _ = mu.rsi(pos, direction, C.PLANET_R)
    cap_proxy = torch.where(base_near > 0.0, base_near, -1.0)
    below = r_len < C.CLOUDS_LOWER_LIMIT
    pre = alive & below
    earth_pre = intersect_land(topo, pos, direction, scale, pre, cfg)
    land_proxy = torch.where(below, earth_pre, cap_proxy)
    event, t_int, iid, c_event, c_t = sample_interaction(
        rng.fold(kb, _SITE_FLIGHT), pos, direction, land_proxy, ext_rmo,
        ext_w, atlas, alive, cfg,
    )
    need_march = alive & ~below & (
        (event == NULL_EVENT)
        | ((iid != C.CLOUD_ID) & (t_int > torch.clamp(d_free, min=0.0)))
    )
    t_cap = torch.where(event > NULL_EVENT, t_int, 1e30)
    earth_post = intersect_land(
        topo, pos, direction, scale, need_march, cfg, t_cap=t_cap
    )
    earth = torch.where(below, earth_pre, earth_post)
    # demote RMO events beyond the land hit; the cloud event takes over
    demote = (
        (event > NULL_EVENT) & (iid != C.CLOUD_ID)
        & (earth >= 0.0) & (earth <= t_int)
    )
    resurrect = demote & (c_event > NULL_EVENT)
    event = torch.where(
        demote, torch.where(resurrect, c_event, NULL_EVENT), event
    ).to(torch.int32)
    t_int = torch.where(resurrect, c_t, t_int)
    iid = torch.where(resurrect, C.CLOUD_ID, iid).to(torch.int32)
    # hero-packet MIS weight of this bounce's flight outcome
    rmo_t0, rmo_t1 = _rmo_span(pos, direction, earth)
    t_w = torch.where(
        event > NULL_EVENT, t_int, torch.where(earth > 0.0, earth, rmo_t1)
    )
    t_w = torch.minimum(torch.maximum(t_w, rmo_t0), torch.maximum(rmo_t1, rmo_t0))
    rmo_collision = (event > NULL_EVENT) & (iid != C.CLOUD_ID)
    w_mult = spectral_flight_weights(
        pos, direction, rmo_t0, t_w, ext_rmo, iid, rmo_collision, alive
    )
    w_mis = w_mis * w_mult
    throughput = throughput * w_mult
    iid = torch.where(
        (bounce > C.MULTISCATTER_BOUNCE) & (iid == C.CLOUD_ID),
        C.ISOTROPIC_CLOUD_ID, iid,
    ).to(torch.int32)
    denom = torch.clamp(mu.sum_last(lambda_pdf * w_mis), min=1e-12)[:, None]

    u_c = rng.uniform(rng.fold(kb, _SITE_CONE), (2,))
    light_dir = smp.sample_cone_oriented(
        u_c[0], u_c[1], scene.sun_cos_angle, light_direction
    )

    scatter = alive & (event == SCATTER_EVENT)
    surface = alive & (event == NULL_EVENT) & (earth > 0.0)
    miss = alive & (event == NULL_EVENT) & ~(earth > 0.0)

    t_safe = torch.where(scatter, t_int, 0.0)
    int_pos = pos + t_safe[:, None] * direction
    _, planet_far = mu.rsi(int_pos, light_dir, C.PLANET_R)
    vol_nee = scatter & ~(planet_far > 0.0)

    # surface work on the surface lanes only (their values are the only
    # ones the bounce reads)
    offset_pos = pos.clone()
    sur_vis = torch.zeros((n,), dtype=torch.bool, device=dev)
    emissive = torch.zeros((n,), device=dev)
    d_term = torch.zeros((n, L), device=dev)
    hemi_dir = torch.tensor([0.0, 1.0, 0.0], device=dev).expand(n, 3).clone()
    b_brdf = torch.zeros((n, L), device=dev)
    u_h = rng.uniform(rng.fold(kb, _SITE_HEMI), (2,))
    s_idx = torch.nonzero(surface).squeeze(1)
    if s_idx.numel():
        s_dir = direction[s_idx]
        land_pos = pos[s_idx] + earth[s_idx][:, None] * s_dir
        normal = land_normal(topo, land_pos, scale, cfg.bilinear_materials)
        albedo_srgb, ocean, bathymetry, s_emissive = get_land_material(
            atlas, land_pos, cfg.bilinear_materials
        )
        albedo = sp.srgb_to_spectrum(
            luts.srgb2spec, albedo_srgb[:, None, :], wavelength[s_idx]
        )
        s_offset = land_pos * (1.0 + 0.0001 * scale / 12000.0)
        shadow_hit = intersect_land(
            topo, s_offset, light_dir[s_idx].contiguous(), scale,
            torch.ones_like(s_idx, dtype=torch.bool), cfg, any_hit=True,
        )
        dd, ds, dn = srf.earth_brdf_parts(ocean, bathymetry, -s_dir, normal, light_dir[s_idx])
        s_hemi = smp.sample_hemisphere_cosine_weighted(u_h[0][s_idx], u_h[1][s_idx], normal)
        bd, bs, _ = srf.earth_brdf_parts(ocean, bathymetry, -s_dir, normal, s_hemi)
        offset_pos[s_idx] = s_offset
        sur_vis[s_idx] = shadow_hit < 0.0
        emissive[s_idx] = s_emissive
        d_term[s_idx] = (albedo * dd[:, None] + ds[:, None]) * dn[:, None]
        hemi_dir[s_idx] = s_hemi
        b_brdf[s_idx] = albedo * bd[:, None] + bs[:, None]
    sur_nee = surface & sur_vis

    nee_origin = torch.where(surface[:, None], offset_pos, int_pos)
    nee_active = vol_nee | sur_nee
    trans = sample_transmittance(
        rng.fold(kb, _SITE_TRANS), nee_origin, light_dir.contiguous(), ext_rmo,
        ext_w, atlas, nee_active, cfg,
    )

    reduce_peak = bounce > 0
    phase_d = vol.evaluate_phase(direction, light_dir, iid, reduce_peak)
    radiance = radiance + torch.where(
        vol_nee[:, None],
        throughput * trans * sun_irradiance * phase_d[:, None] / denom, 0.0,
    )
    radiance = radiance + torch.where(
        surface[:, None], throughput * emissive[:, None] * nightlights_power / denom, 0.0,
    )
    radiance = radiance + torch.where(
        sur_nee[:, None], throughput * trans * sun_irradiance * d_term / denom, 0.0,
    )

    u_ph = rng.uniform(rng.fold(kb, _SITE_PHASE), (3,))
    phase_dir, phase_w = vol.sample_phase_dirs(
        u_ph[0], u_ph[1], u_ph[2], direction, iid, reduce_peak
    )
    new_dir = torch.where(
        scatter[:, None], phase_dir,
        torch.where(surface[:, None], hemi_dir, direction),
    )
    new_pos = torch.where(
        scatter[:, None], int_pos, torch.where(surface[:, None], offset_pos, pos)
    )
    new_thr = torch.where(
        scatter[:, None],
        throughput * phase_w[:, None],
        torch.where(surface[:, None], throughput * b_brdf * math.pi, throughput),
    )
    primary_miss = st.primary_miss | (miss & (bounce == 0))
    alive = scatter | surface

    # Russian roulette on the hero throughput
    if bounce > cfg.rr_start:
        p_kill = torch.clamp(1.0 - new_thr[:, 0], min=0.05)
        u_rr = rng.uniform(rng.fold(kb, _SITE_RR))
        killed = alive & (u_rr < p_kill)
        new_thr = torch.where(
            (alive & ~killed)[:, None], new_thr / (1.0 - p_kill[:, None]), new_thr
        )
        alive = alive & ~killed

    return TraceState(
        pos=new_pos, direction=new_dir, wavelength=wavelength,
        lambda_pdf=lambda_pdf, throughput=new_thr, radiance=radiance,
        w_mis=w_mis, alive=alive, primary_miss=primary_miss, rng=st.rng,
    )


def run_bounces(st: TraceState, scene: SceneParams, atlas, luts,
                cfg: TraceConfig, bounce_start: int, bounce_stop: int) -> TraceState:
    """Advance the wavefront over bounces [bounce_start, bounce_stop), each
    bounce on the alive lanes only (stable gather, then scatter back)."""
    for bounce in range(bounce_start, bounce_stop):
        live = torch.nonzero(st.alive).squeeze(1)
        if live.numel() == 0:
            break
        if live.numel() == st.alive.numel():
            st = run_bounce(st, bounce, scene, atlas, luts, cfg)
        else:
            st.put(live, run_bounce(st.take(live), bounce, scene, atlas, luts, cfg))
    return st


def shade_primary_miss(st: TraceState, scene: SceneParams, atlas, luts,
                       cfg: TraceConfig) -> TraceState:
    """Sun disk + stars for primary-miss lanes (pathtracer.py:2000)."""
    final_denom = torch.clamp(mu.sum_last(st.lambda_pdf * st.w_mis), min=1e-12)[:, None]
    sun_power = sp.plancks(C.SUN_TEMPERATURE, st.wavelength)
    sun_hit = st.primary_miss & (
        mu.dot(scene.light_direction.expand_as(st.direction), st.direction)
        > scene.sun_cos_angle
    )
    radiance = st.radiance + torch.where(
        sun_hit[:, None], st.throughput * sun_power / final_denom, 0.0
    )
    stars_srgb = tx.sample_dir_texture(atlas.stars, st.direction, cfg.bilinear_materials)
    stars_power = sp.srgb_to_spectrum(luts.srgb2spec, stars_srgb[:, None, :], st.wavelength)
    radiance = radiance + torch.where(
        st.primary_miss[:, None],
        st.throughput * stars_power * sun_power * C.STARS_SCALE / final_denom,
        0.0,
    )
    st.radiance = radiance
    return st


def finalize_radiance(st: TraceState):
    """NaN/Inf/negative clamp."""
    r = st.radiance
    return torch.where(torch.isfinite(r) & (r >= 0.0), r, 0.0)
