"""Wavefront spectral volumetric path tracer (port of
digital_earth_tpu/render/pathtracer.py), at the default configuration and
at the reference's estimator (``TraceConfig`` hero_lambdas 1 or 4,
analytic_transmittance True or False).

The scene and march options of ``TraceConfig`` (``params.SCENE_OPTIONS``)
run through the twins and, at any of the six flags off its default, the
kernels' options instances (every instance takes the stall patience). So
do the naive arm's four flags (``params.NAIVE_OPTIONS``), which swap the
accelerated loops for the reference-faithful ones of ``tracking_naive``:
``naive_tracking`` all of them (march first, single-wavelength paths),
``naive_march`` the three marches, ``naive_cloud_tracking`` the two cloud
passes and ``naive_shadow`` the surface's shadow march. So do the
estimator options (``params.ESTIMATOR_OPTIONS``): ``analytic_flight`` the
gases' flight by inverting their optical depth (``tracers.
sample_rmo_flight_analytic``), ``fast_loop_rng`` the accelerated trackers'
counter-hash draws, the NEE and cloud Russian roulettes (``nee_rr_*``,
``cloud_rr_*``, sites 7 and 8) and ``nee_off``. So do the march floors
(``params.FLOOR_OPTIONS``): the certified floor (``march_certified_floor``
with ``march_uncert_floor_frac``) in every accelerated march, and the
secondary floor (``march_floor_frac_secondary``) in the primary marches past
bounce 0, each bounce's floors from ``tracers._march_floor``; the shadow
march keeps ``march_floor_frac``.

One bounce of the reference's ``run_bounces`` body (pathtracer.py:1554-1924)
is ``run_bounce``: for CUDA tensors the kernels ``bounce_flight`` and
``bounce_shade`` (csrc/bounce.cu, at the instance of the packet width and
the sun transmittance; their census instances count the loops' trips), for
CPU tensors its plain twin ``run_bounce_plain`` (the eager body, with the
per-lane loops of ``tracers.py``). ``run_bounces``
applies it one bounce at a time to the lanes that are still alive, listed by
``compact.compact_by_alive`` (binned by work class, stable; the kernel
``compact_lanes`` on the card). On the card, once the live count falls
below the lanes that fill the card, one launch of ``bounce_window`` carries
the remaining lanes through every remaining bounce (twin:
``run_window_plain``; the schedule: ``bounce_schedule``). A dead lane is a
no-op in the reference's body, and every random draw is keyed per lane, so
the image does not depend on this schedule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace

import torch

from .. import constants as C

from .. import kernels
from ..models import atmosphere_lut as atm
from ..models import surface as srf
from ..models import volume as vol
from ..ops import math_utils as mu
from ..ops import rng
from ..ops import sampling as smp
from ..ops import spectral as sp
from ..ops import texture as tx
from . import compact
from . import tracking_naive as tn
from .params import SceneParams, TraceConfig
from .tracers import (  # noqa: F401  (re-exported loop entry points)
    ABSORB_EVENT, NULL_EVENT, SCATTER_EVENT, _CLOUD_VALID, _MIP_VALID_COARSE, _MIP_VALID_FINE,
    _march_floor, delta_track_rmo, delta_track_rmo_plain, intersect_land, intersect_land_plain,
    ratio_track_rmo, ratio_track_rmo_plain, sample_rmo_flight_analytic,
    sample_rmo_flight_analytic_plain, track_cloud, track_cloud_plain,
)

# RNG site ids (pathtracer.py:62-71): lane key -> bounce -> site -> loop.
_SITE_FLIGHT = 1
_SITE_CONE = 2
_SITE_TRANS = 3
_SITE_PHASE = 4
_SITE_HEMI = 5
_SITE_RR = 6
_SITE_NEE_RR = 7
_SITE_CLOUD_RR = 8
_SUB_RMO = 1
_SUB_CLOUD = 2

# The bounce's loop sites, the columns of a trip-count census (csrc/bounce.cuh
# SITE_*): the march before the flight (lanes below the cloud slab), cloud
# delta tracking, RMO delta tracking, the march after the flight, the
# surface's shadow march, the sun's cloud ratio tracking and, with
# ``TraceConfig.analytic_transmittance`` False, the sun's RMO ratio tracking.
CENSUS_SITES = ("pre_march", "cloud", "rmo", "post_march", "shadow", "nee_cloud", "nee_rmo")


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


def _naive_ext(ext_rmo=None, ext_w=None):
    """The naive trackers' (n, 4) extinctions: the gases' hero three, or the
    cloud's in channel 3."""
    if ext_rmo is not None:
        return torch.cat([ext_rmo[:, 0, :], torch.zeros_like(ext_rmo[:, 0, :1])], dim=-1)
    return torch.cat([torch.zeros((ext_w.shape[0], 3), device=ext_w.device), ext_w[:, None]],
                     dim=-1)


def _naive(fn, args, trips, site):
    """A naive tracker: the wrapper, or its plain version adding the trips to
    census column ``site``."""
    if trips is None:
        return fn(*args)
    return getattr(tn, f"{fn.__name__}_plain")(*args, trips=trips[:, site])


def _naive_cloud(fn, keys, ray_pos, ray_dir, c_start, c_max, ext_w, atlas, active, cfg, trips,
                 site):
    """A naive cloud pass at the cloud's global majorant, ``ext_w`` times the
    cloud density's."""
    return _naive(fn, (keys, ray_pos, ray_dir, c_start, c_max, _naive_ext(ext_w=ext_w),
                       ext_w * C.CLOUDS_DENSITY, atlas.clouds, "cloud", active, cfg), trips, site)


def _sample_interaction_naive(k_rmo, k_cloud, ray_pos, ray_dir, land_isection, ext_rmo, ext_w,
                              atlas, active, cfg, trips):
    """The naive arm's flight (pathtracer.py:1263-1288): the gases over the
    whole span, then the cloud where no gas event lies before the slab; the
    nearer event wins."""
    t_start, t_max = _rmo_span(ray_pos, ray_dir, land_isection)
    rmo_event, rmo_t, rmo_id = _naive(tn.delta_track_naive, (
        k_rmo, ray_pos, ray_dir, t_start, t_max, _naive_ext(ext_rmo=ext_rmo),
        vol.max_extinction_rmo(ext_rmo), atlas.clouds, "rmo", active, cfg), trips, 2)
    if not cfg.enable_clouds:
        return (rmo_event, rmo_t, rmo_id, torch.zeros_like(rmo_event),
                torch.zeros_like(rmo_t))
    c_start, c_max = intersect_cloud_limits(ray_pos, ray_dir, land_isection)
    cloud_active = active & ((rmo_event == NULL_EVENT) | (rmo_t > c_start))
    c_event, c_t, _ = _naive_cloud(tn.delta_track_naive, k_cloud, ray_pos, ray_dir, c_start,
                                   c_max, ext_w, atlas, cloud_active, cfg, trips, 1)
    take = cloud_active & (c_event > NULL_EVENT) & ((c_t < rmo_t) | (rmo_event == NULL_EVENT))
    event = torch.where(take, c_event, rmo_event)
    t = torch.where(take, c_t, rmo_t)
    iid = torch.where(take, C.CLOUD_ID, rmo_id).to(torch.int32)
    return event, t, iid, torch.where(cloud_active, c_event, 0), c_t


def sample_interaction(keys, ray_pos, ray_dir, land_isection, ext_rmo, ext_w,
                       atlas, active, cfg: TraceConfig, trips=None):
    """Cloud pass, then the RMO pass capped at the cloud event; the nearer
    event wins (pathtracer.py:1236). Returns (event, t, iid, c_event, c_t);
    without clouds (``cfg.enable_clouds`` False) the RMO pass alone, with a
    zero cloud event (:1315). ``cfg.naive_tracking``: the naive arm's order
    (``_sample_interaction_naive``); ``cfg.naive_cloud_tracking``: the naive
    cloud pass; ``cfg.analytic_flight``: the gases' flight by inverting
    their optical depth (:1306). With ``trips`` (n, 7) int32 the plain loops
    run and add their iterations to the census columns of the two passes."""
    k_rmo = rng.fold(keys, _SUB_RMO)
    k_cloud = rng.fold(keys, _SUB_CLOUD)
    if cfg.naive_tracking:
        return _sample_interaction_naive(k_rmo, k_cloud, ray_pos, ray_dir, land_isection,
                                         ext_rmo, ext_w, atlas, active, cfg, trips)
    t_start, t_max = _rmo_span(ray_pos, ray_dir, land_isection)
    if cfg.enable_clouds:
        c_start, c_max = intersect_cloud_limits(ray_pos, ray_dir, land_isection)
        cloud_args = (k_cloud, ray_pos, ray_dir, c_start, c_max, ext_w, atlas.clouds, active,
                      cfg)
        if cfg.naive_cloud_tracking:
            c_event, c_t, _ = _naive_cloud(tn.delta_track_naive, k_cloud, ray_pos, ray_dir,
                                           c_start, c_max, ext_w, atlas, active, cfg, trips, 1)
        elif trips is None:
            c_event, c_t = track_cloud(*cloud_args, mode="delta")
        else:
            c_event, c_t = track_cloud_plain(*cloud_args, mode="delta", trips=trips[:, 1])
        # the RMO pass only needs to reach the cloud event
        rmo_cap = torch.where(c_event > NULL_EVENT, torch.minimum(t_max, c_t), t_max)
    else:
        rmo_cap = t_max
    rmo_args = (k_rmo, ray_pos, ray_dir, t_start, rmo_cap, ext_rmo[:, 0, :].contiguous(),
                active, cfg)
    flight, flight_plain = ((sample_rmo_flight_analytic, sample_rmo_flight_analytic_plain)
                            if cfg.analytic_flight else (delta_track_rmo, delta_track_rmo_plain))
    if trips is None:
        rmo_event, rmo_t, rmo_id = flight(*rmo_args)
    else:
        rmo_event, rmo_t, rmo_id = flight_plain(*rmo_args, trips=trips[:, 2])
    if not cfg.enable_clouds:
        return (rmo_event, rmo_t, rmo_id, torch.zeros_like(rmo_event),
                torch.zeros_like(rmo_t))
    take_cloud = (c_event > NULL_EVENT) & (rmo_event == NULL_EVENT)
    event = torch.where(take_cloud, c_event, rmo_event)
    t = torch.where(take_cloud, c_t, rmo_t)
    iid = torch.where(take_cloud, C.CLOUD_ID, rmo_id).to(torch.int32)
    return event, t, iid, c_event, c_t


def sample_transmittance(keys, ray_pos, ray_dir, ext_rmo, ext_w, atlas,
                         active, cfg: TraceConfig, trips=None):
    """Sun transmittance (n, L): the gases' term times cloud ratio tracking
    (pathtracer.py:1326). The gases' term is the exact closed form from the
    density table, or with ``cfg.analytic_transmittance`` False the
    reference's estimator, ratio tracking to space at the packet majorant
    (:1348-1354); without clouds the gases' term alone (:1355). The naive
    arm (:1341-1366): ``cfg.naive_tracking`` takes both terms by naive ratio
    tracking, ``cfg.naive_cloud_tracking`` the cloud's. With ``trips`` (n, 7)
    int32 the plain loops run and add their iterations to the census columns
    of the NEE passes."""
    k_cloud = rng.fold(keys, _SUB_CLOUD)
    no_land = torch.full_like(ext_w, -1.0)
    if cfg.naive_tracking:
        t_start, t_max = _rmo_span(ray_pos, ray_dir, no_land)
        trans = _naive(tn.ratio_track_naive, (
            rng.fold(keys, _SUB_RMO), ray_pos, ray_dir, t_start, t_max,
            _naive_ext(ext_rmo=ext_rmo), vol.max_extinction_rmo(ext_rmo), atlas.clouds, "rmo",
            active, cfg), trips, 6)[:, None]
    elif cfg.analytic_transmittance:
        trans = atm.rmo_transmittance_to_space(ext_rmo, ray_pos, ray_dir)
    else:
        t_start, t_max = _rmo_span(ray_pos, ray_dir, no_land)
        rmo_args = (rng.fold(keys, _SUB_RMO), ray_pos, ray_dir, t_start, t_max, ext_rmo,
                    vol.max_extinction_rmo(ext_rmo), active, cfg)
        if trips is None:
            trans = ratio_track_rmo(*rmo_args)
        else:
            trans = ratio_track_rmo_plain(*rmo_args, trips=trips[:, 6])
    if not cfg.enable_clouds:
        return trans
    c_start, c_max = intersect_cloud_limits(ray_pos, ray_dir, no_land)
    cloud_args = (k_cloud, ray_pos, ray_dir, c_start, c_max, ext_w, atlas.clouds, active, cfg)
    if cfg.naive_tracking or cfg.naive_cloud_tracking:
        cloud_trans = _naive_cloud(tn.ratio_track_naive, k_cloud, ray_pos, ray_dir, c_start,
                                   c_max, ext_w, atlas, active, cfg, trips, 5)
    elif trips is None:
        cloud_trans = track_cloud(*cloud_args, mode="ratio")
    else:
        cloud_trans = track_cloud_plain(*cloud_args, mode="ratio", trips=trips[:, 5])
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
    # class of the lane's next bounce, the live list's bin: 0 cloud scatter,
    # 1 gas scatter, 2 surface bounce
    work_class: torch.Tensor   # (N,) int32

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
        work_class=torch.zeros((n,), dtype=torch.int32, device=dev),
    )


def run_bounce_plain(st: TraceState, bounce: int, scene: SceneParams, atlas, luts,
                     cfg: TraceConfig, trips=None) -> TraceState:
    """Plain PyTorch twin of one bounce (the kernels ``bounce_flight`` +
    ``bounce_shade``, and each bounce of ``bounce_window``): one bounce of
    every lane in ``st`` (all alive), the reference's ``run_bounces`` body
    at ``bounce`` (pathtracer.py:1554-1924), in a new state. With ``trips``, an
    (n, 7) int32 tensor, the loops run as their plain versions (on any
    device) and add each lane's iterations at the seven loop sites
    (``CENSUS_SITES``), as the kernels' census instances count them."""
    naive_march = cfg.naive_march or cfg.naive_tracking
    # the primary marches' floors at this bounce (march_floor_frac_secondary
    # past bounce 0); the shadow march keeps the march's own
    floor = _march_floor(atlas.topography, cfg, bounce)

    def land(*args, site, t_cap=None):
        if naive_march:  # the plain sphere march takes no cap
            return _naive(tn.intersect_land_naive, args, trips, site)
        if trips is None:
            return intersect_land(*args, t_cap=t_cap, floor=floor)
        return intersect_land_plain(*args, t_cap=t_cap, trips=trips[:, site], floor=floor)

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
    # terrain-free ball; only lanes whose flight leaves it march. March
    # first (``cfg.lazy_march`` False, the reference's order, pathtracer.py:
    # 1582-1591): every live lane marches at the first site, the flight is
    # capped at its hit, and no lane marches after it nor is demoted. The
    # naive arm always marches first.
    first = not cfg.lazy_march or cfg.naive_tracking
    tap = tx.sample_sphere_texture(topo, pos, bilinear=cfg.bilinear_tracking)
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
    below = (r_len < C.CLOUDS_LOWER_LIMIT) | first
    pre = alive & below
    earth_pre = land(topo, pos, direction, scale, pre, cfg, site=0)
    land_proxy = torch.where(below, earth_pre, cap_proxy)
    event, t_int, iid, c_event, c_t = sample_interaction(
        rng.fold(kb, _SITE_FLIGHT), pos, direction, land_proxy, ext_rmo,
        ext_w, atlas, alive, cfg, trips=trips,
    )
    need_march = alive & ~below & (
        (event == NULL_EVENT)
        | ((iid != C.CLOUD_ID) & (t_int > torch.clamp(d_free, min=0.0)))
    )
    t_cap = torch.where(event > NULL_EVENT, t_int, 1e30)
    earth_post = land(topo, pos, direction, scale, need_march, cfg, t_cap=t_cap, site=3)
    earth = torch.where(below, earth_pre, earth_post)
    # demote RMO events beyond the land hit; the cloud event takes over
    demote = (
        (event > NULL_EVENT) & (iid != C.CLOUD_ID)
        & (earth >= 0.0) & (earth <= t_int) & (not first)
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
        s_trips = None if trips is None else torch.zeros_like(trips[s_idx])
        shadow_args = (topo, s_offset, light_dir[s_idx].contiguous(), scale,
                       torch.ones_like(s_idx, dtype=torch.bool), cfg)
        if cfg.nee_off:  # "occluded": no sun NEE, no shadow march
            shadow_hit = torch.ones_like(s_offset[:, 0])
        elif naive_march or cfg.naive_shadow:
            shadow_hit = _naive(tn.intersect_land_naive, shadow_args, s_trips, 4)
        elif trips is None:
            shadow_hit = intersect_land(*shadow_args, any_hit=True)
        else:
            shadow_hit = intersect_land_plain(*shadow_args, any_hit=True, trips=s_trips[:, 4])
        if trips is not None:
            trips[s_idx] += s_trips
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
    # the NEE roulette past nee_rr_start: keep the sun's track with
    # probability nee_rr_prob, its transmittance reweighted by
    # float32(1 / nee_rr_prob) (pathtracer.py:1802-1830)
    nee_rr = cfg.nee_rr_prob < 1.0 and bounce > cfg.nee_rr_start
    if nee_rr:
        nee_keep = rng.uniform(rng.fold(kb, _SITE_NEE_RR)) < cfg.nee_rr_prob
        nee_active = nee_active & nee_keep
    if cfg.nee_off:  # no sun NEE at all (pathtracer.py:1813-1820)
        trans = torch.zeros((n, L), device=dev)
        vol_nee = torch.zeros_like(vol_nee)
        sur_nee = torch.zeros_like(sur_nee)
    else:
        trans = sample_transmittance(
            rng.fold(kb, _SITE_TRANS), nee_origin, light_dir.contiguous(), ext_rmo,
            ext_w, atlas, nee_active, cfg, trips=trips,
        )
    if nee_rr:
        trans = trans * torch.where(nee_active, 1.0 / cfg.nee_rr_prob, 0.0)[:, None]
        vol_nee = vol_nee & nee_keep
        sur_nee = sur_nee & nee_keep

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

    # the cloud roulette from cloud_rr_start: a cloud-scattered path goes on
    # with probability cloud_rr_keep, its throughput times float32(1 /
    # cloud_rr_keep) (pathtracer.py:1884-1895 divide by the Python float,
    # which PyTorch on the card applies so: the twin is the card's on any
    # device)
    in_cloud = (iid == C.CLOUD_ID) | (iid == C.ISOTROPIC_CLOUD_ID)
    if cfg.cloud_rr_keep < 1.0 and bounce >= cfg.cloud_rr_start:
        crr = alive & scatter & in_cloud
        ckilled = crr & (rng.uniform(rng.fold(kb, _SITE_CLOUD_RR)) >= cfg.cloud_rr_keep)
        new_thr = torch.where((crr & ~ckilled)[:, None], new_thr * (1.0 / cfg.cloud_rr_keep),
                              new_thr)
        alive = alive & ~ckilled

    # class of the next bounce (pathtracer.py:1918-1919)
    cls = torch.where(scatter & in_cloud, 0, torch.where(scatter, 1, 2)).to(torch.int32)
    return TraceState(
        pos=new_pos, direction=new_dir, wavelength=wavelength,
        lambda_pdf=lambda_pdf, throughput=new_thr, radiance=radiance,
        w_mis=w_mis, alive=alive, primary_miss=primary_miss, rng=st.rng,
        work_class=torch.where(alive, cls, st.work_class),
    )


def scene_floats(scene: SceneParams):
    """The kernels' scene scalars: (land height scale, light direction (3),
    sun cos angle, the sun cone's solid angle, the surface offset 1 + 1e-4
    scale / 12000), from the scene's host record, touching no tensor. Each
    was computed once, when the scene was made, by the twins' own float32
    arithmetic on the scene's device (``params.host_scene``): the kernels
    must take the bits the twins compute, and PyTorch rounds a Python
    divisor on the card otherwise than on the CPU."""
    return tuple(scene.host)


class BounceFrame:
    """The bounce kernels' arguments that hold for a whole wavefront: the
    scene's scalars from its host record, the budgets and options of
    ``cfg`` (the scene and march options, then the estimator options' ints
    and the certified floor's flag, after the sixteen ints the default
    instances read; the estimator options' probabilities, then the primary
    marches' floors and stall thresholds at bounce 0 and past it and the
    uncertified floor, after the sixteen floats, whose step floor and stall
    threshold are the shadow march's), the lane keys as int32 once, the
    density table (pathtracer.run_bounces builds one per call)."""

    def __init__(self, st: TraceState, scene: SceneParams, atlas, luts, cfg: TraceConfig):
        topo = atlas.topography
        scale_f, light, cos_angle, solid_angle, offset_scale = scene_floats(scene)
        shadow, first, past = (_march_floor(topo, cfg, b) for b in (None, 0, 1))
        est_ints, est_floats = kernels.bounce_estimator_params(cfg)
        self.fparams = [scale_f, shadow.step_floor, shadow.stall_thresh, atm._O3_ENV_PEAK, *light,
                        cos_angle, solid_angle, offset_scale, *sp.planck_kernel_constants(),
                        *vol.MAX_DENS_RMO, *est_floats, first.step_floor, first.stall_thresh,
                        past.step_floor, past.stall_thresh,
                        shadow.step_floor if shadow.uncert_floor is None else shadow.uncert_floor]
        # naive_tracking takes the gases' sun transmittance from the ratio
        # instances' tracker at one probe an iteration: the naive ratio
        # tracker's one-step loop, draw for draw (csrc/bounce.cuh); its other
        # loops read no tracking_k
        naive = cfg.naive_tracking
        self.iparams = [
            st.wavelength.shape[1], 0, cfg.rr_start, cfg.land_march_steps, cfg.march_k,
            cfg.march_stall_patience, cfg.max_tracking_steps, 1 if naive else cfg.tracking_k,
            int(cfg.bilinear_materials), *topo.shape[:2], *atlas.material.shape[:2],
            *atlas.clouds.shape[:2], int(naive or not cfg.analytic_transmittance),
            *(int(getattr(cfg, name)) for name in kernels.BOUNCE_OPTIONS), *est_ints,
        ]
        self.keys = kernels.keys_i32(st.rng)
        self.tables = (topo, atlas.material, atlas.clouds, luts.o3_crossec, luts.srgb2spec,
                       atm.density_table(st.pos.device))


def run_bounce(st: TraceState, idx, bounce: int, scene: SceneParams, atlas, luts,
               cfg: TraceConfig, frame: BounceFrame = None, n_live=None):
    """One bounce of the lanes ``idx`` (int32, all alive) of ``st``, in
    place: for CUDA tensors the kernels ``bounce_flight`` and
    ``bounce_shade`` (one bounce split at the flight's end, so that the
    flight runs at twice the occupancy: 3.1 ms against 6.3 ms for the same
    bits from one kernel at 1080p Apollo bounce 0 on an H100, PERF.md) with
    ``frame`` as built for ``st`` (or built here), and with ``n_live``, the
    (1,) live count on the device, the entries of ``idx`` at or past it
    skipped; its plain twin on ``st.take(idx)`` for CPU tensors."""
    if st.pos.device.type == "cpu":
        idx = idx.to(torch.int64)
        st.put(idx, run_bounce_plain(st.take(idx), bounce, scene, atlas, luts, cfg))
        return
    args = _kernel_args(st, idx, bounce, scene, atlas, luts, cfg, frame)
    kernels.bounce_shade(*args, flight=kernels.bounce_flight(*args, n_live=n_live),
                         n_live=n_live)


def _kernel_args(st, idx, bounce, scene, atlas, luts, cfg, frame):
    if frame is None:
        frame = BounceFrame(st, scene, atlas, luts, cfg)
    iparams = list(frame.iparams)
    iparams[1] = bounce
    return (frame.fparams, iparams, st.pos, st.direction, st.wavelength, st.lambda_pdf,
            st.throughput, st.radiance, st.w_mis, st.alive, st.primary_miss, st.work_class,
            frame.keys, idx, *frame.tables)


def run_window(st: TraceState, idx, bounce_start: int, bounce_stop: int, scene: SceneParams,
               atlas, luts, cfg: TraceConfig, frame: BounceFrame = None, n_live=None):
    """Bounces [bounce_start, bounce_stop) of the lanes ``idx`` (int32, all
    alive) of the CUDA state ``st``, in place, in one ``bounce_window``
    launch: each lane runs until it dies, with no list in between (twin:
    ``run_window_plain``); ``n_live`` as ``run_bounce`` takes it."""
    kernels.bounce_window(*_kernel_args(st, idx, bounce_start, scene, atlas, luts, cfg, frame),
                          stop=bounce_stop, n_live=n_live)


def run_window_plain(st: TraceState, idx, bounce_start: int, bounce_stop: int,
                     scene: SceneParams, atlas, luts, cfg: TraceConfig, trips=None):
    """Plain twin of ``bounce_window``: bounces [bounce_start, bounce_stop) of
    the fixed set of lanes ``idx`` of ``st`` (all alive at the start), in
    place, each bounce ``run_bounce_plain`` on the set's lanes still alive,
    listed as ``run_bounces`` lists them (binned, stable). With ``trips``, a
    (bounce_stop - bounce_start, N, 7) int32 tensor, each bounce's trip
    counts land at its lanes."""
    lanes = torch.sort(idx.to(torch.int64)).values  # each bin in lane order, as run_bounces
    for b in range(bounce_start, bounce_stop):
        order, n_live = compact.compact_by_alive_plain(st.alive[lanes], st.work_class[lanes])
        live = lanes[order[: int(n_live)].to(torch.int64)]
        if live.numel() == 0:
            break
        t = None if trips is None else torch.zeros_like(trips[0, live])
        st.put(live, run_bounce_plain(st.take(live), b, scene, atlas, luts, cfg, trips=t))
        if trips is not None:
            trips[b - bounce_start, live] = t
    return st


def bounce_schedule(n: int, counts, window_at: int, bounce_start: int, bounce_stop: int):
    """The card's schedule of ``run_bounces`` for a wavefront of ``n`` lanes
    whose live counts entering bounces bounce_start, bounce_start + 1, ...
    are ``counts``: (the bounces launched one per launch, the bounce at which
    one ``bounce_window`` launch takes the rest, or None). Each launch's grid
    is the last count the host has read (n at first); the host reads a
    bounce's count once that bounce is queued, stops once a count is 0, and
    takes the window once the count it holds is below ``window_at``."""
    single, bound = [], n
    for b in range(bounce_start, bounce_stop):
        if bound < window_at:
            return single, b
        single.append(b)
        bound = counts[b - bounce_start]
        if bound == 0:
            break
    return single, None


class Interrupted(Exception):
    """``run_bounces`` abandoned its wavefront: the interrupt poll said so."""


def run_bounces(st: TraceState, scene: SceneParams, atlas, luts,
                cfg: TraceConfig, bounce_start: int, bounce_stop: int,
                interrupt=None, window_at=None) -> TraceState:
    """Advance the wavefront over bounces [bounce_start, bounce_stop) in
    place, each bounce on the alive lanes only, listed by work class.

    CPU tensors: each bounce lists the live lanes, reads the count (stopping
    at 0), polls ``interrupt()``, then runs the bounce. CUDA tensors
    (``bounce_schedule``): the live count stays on the device. Before each
    bounce ``interrupt()`` is polled, then the live lanes are listed and the
    bounce is launched with the last count the host read as its grid; the
    list's count is copied to pinned host memory without blocking, and the
    host waits for that copy (an event) once the bounce is queued, that is
    until the previous bounce has ended: the device runs this bounce while
    the host queues the next, so at most one bounce is queued ahead of the
    running one. Once the count the host holds is below ``window_at``
    (default ``kernels.window_threshold``: the lanes that fill the card), one
    ``bounce_window`` launch runs every remaining bounce of the live lanes,
    after one last poll. ``Interrupted`` is raised when the poll returns
    True: on the card at most one bounce (or the window) already queued
    runs past the poll that fires, and the caller drops the aborted spp, as
    on the CPU."""
    if st.pos.device.type == "cpu":
        for bounce in range(bounce_start, bounce_stop):
            idx, n_live = compact.compact_by_alive(st.alive, st.work_class)
            m = int(n_live)
            if m == 0:
                break
            if interrupt is not None and interrupt():
                raise Interrupted
            run_bounce(st, idx[:m], bounce, scene, atlas, luts, cfg)
        return st
    frame = BounceFrame(st, scene, atlas, luts, cfg)
    if window_at is None:
        window_at = kernels.window_threshold(st.pos.device)
    bound = st.alive.shape[0]  # an upper bound of the live count, held by the host
    count = torch.empty((1,), dtype=torch.int32, pin_memory=True)
    read = torch.cuda.Event()
    for bounce in range(bounce_start, bounce_stop):
        if interrupt is not None and interrupt():
            raise Interrupted
        idx, n_live = compact.compact_by_alive(st.alive, st.work_class)
        if bound < window_at:
            run_window(st, idx[:bound], bounce, bounce_stop, scene, atlas, luts, cfg, frame,
                       n_live)
            break
        count.copy_(n_live, non_blocking=True)
        read.record()
        run_bounce(st, idx[:bound], bounce, scene, atlas, luts, cfg, frame, n_live)
        read.synchronize()  # this bounce's count: the previous bounce has ended
        bound = int(count[0])
        if bound == 0:
            break
    return st


def shade_primary_miss(st: TraceState, scene: SceneParams, atlas, luts,
                       cfg: TraceConfig) -> TraceState:
    """Sun disk + stars for primary-miss lanes (pathtracer.py:2000), in a
    new state (``st`` is left as it was). Valid after the last bounce: a
    miss lane is dead from bounce 0 on, with its direction, throughput and
    w_mis frozen."""
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
    return replace(st, radiance=radiance)


def finalize_radiance(st: TraceState):
    """NaN/Inf/negative clamp."""
    r = st.radiance
    return torch.where(torch.isfinite(r) & (r >= 0.0), r, 0.0)


def trace_paths(key, ray_pos, ray_dir, wavelength, scene: SceneParams, atlas, luts,
                cfg: TraceConfig = TraceConfig(), lambda_pdf=None, lane_ids=None):
    """One spectral path per lane from the given rays (pathtracer.py:2043
    trace_paths): the lanes' keys fold the (2,) ``key`` with ``lane_ids``
    (default ``arange(N)``), every bounce runs (the kernels on CUDA tensors),
    then the primary misses are shaded and the radiance clamped. ``wavelength``
    (N,) or (N, L), member 0 the hero, ``lambda_pdf`` (N, L) (default 1).
    Returns the (N,) or (N, L) MIS-weighted radiance (multiply by the CIE
    responses and sum over L for XYZ)."""
    squeeze = wavelength.dim() == 1
    if squeeze:
        wavelength = wavelength[:, None]
    if lambda_pdf is None:
        lambda_pdf = torch.ones_like(wavelength)
    if lane_ids is None:
        lane_ids = torch.arange(ray_pos.shape[0], device=ray_pos.device)
    st = init_state(ray_pos, ray_dir, wavelength, lambda_pdf, rng.lane_keys(key, lane_ids))
    st = run_bounces(st, scene, atlas, luts, cfg, 0, cfg.max_bounces)
    radiance = finalize_radiance(shade_primary_miss(st, scene, atlas, luts, cfg))
    return radiance[:, 0] if squeeze else radiance
