"""Deterministic single-scatter preview (port of
digital_earth_tpu/render/raymarcher.py): fixed-step quadrature of single
scattering (64 steps, each with a 16-step sun transmittance) plus the land
surface shading, 3 bounces, noise-free at 1 spp.

``march_paths`` is the whole preview per lane: for CUDA tensors one launch
of the kernel ``preview`` (csrc/preview.cu), for CPU tensors its plain twin
``march_paths_plain`` (the eager body). On the card the twin's land marches
and its single-scatter march run the ``land_march`` and ``atmos_march``
kernels, whose device functions ``preview`` calls too; ``ray_march_atmos``
is that march (``ray_march_atmos_plain`` its twin).

The randomness is per pixel tile, as in the reference: the tile key is
``fold(spp_key, tile_index)``, split three ways per bounce, and a lane's
draws sit at its in-tile index ``li`` (and ``tile + li`` for the second
coordinate) of ``uniform(k, (2, tile))``.
"""

from __future__ import annotations

import math

import torch

from .. import constants as C
from .. import kernels
from ..models import surface as srf
from ..models import volume as vol
from ..ops import math_utils as mu
from ..ops import rng
from ..ops import sampling as smp
from ..ops import spectral as sp
from ..ops import texture as tx
from .params import SceneParams, TraceConfig
from .pathtracer import (_march_floor, get_land_material, intersect_land, land_normal,
                         scene_floats)

_TRANSMITTANCE_STEPS = 16
_MARCH_STEPS = 64
_BOUNCES = 3


def ray_march_transmittance(ray_pos, ray_dir, rmo_extinction):
    """16-step quadrature of the sun transmittance (raymarcher.py:34)."""
    _, planet_far = mu.rsi(ray_pos, ray_dir, C.PLANET_R)
    occluded = planet_far > 0.0
    _, a_far = mu.rsi(ray_pos, ray_dir, C.ATMOS_UPPER_LIMIT)
    t_max = torch.where(a_far < 0.0, -1.0, a_far)
    dd = (t_max / _TRANSMITTANCE_STEPS)[:, None]
    od = torch.zeros_like(ray_pos)
    pos = ray_pos
    for _ in range(_TRANSMITTANCE_STEPS):
        od = od + vol.get_density(vol.get_elevation(pos)) * dd
        pos = pos + dd * ray_dir
    trans = torch.exp(-mu.sum_last(rmo_extinction * od))
    return torch.where(occluded, 0.0, trans)


def ray_march_atmos_plain(ray_pos, ray_dir, t_start, t_max, sun_dir,
                          rmo_extinction, rm_scattering, active):
    """Plain PyTorch twin of the ``atmos_march`` kernel: the 64-step
    single-scatter march (raymarcher.py:56) -> (in_scatter, transmittance),
    (0, 1) on lanes that are not ``active``."""
    dd = (t_max - t_start) / _MARCH_STEPS
    pos = ray_pos + t_start[:, None] * ray_dir
    cos_theta = mu.dot(ray_dir, sun_dir)
    phase = torch.stack([vol.rayleigh_phase(cos_theta), vol.mie_phase(cos_theta)], dim=-1)
    in_scatter = torch.zeros_like(t_start)
    trans = torch.ones_like(t_start)
    for _ in range(_MARCH_STEPS):
        density = vol.get_density(vol.get_elevation(pos))
        step_od = mu.sum_last(rmo_extinction * density * dd[:, None])
        step_trans = mu.saturate(torch.exp(-step_od))
        step_integral = mu.saturate((1.0 - step_trans) / torch.clamp(step_od, min=1e-8))
        visible = trans * step_integral
        sun_trans = ray_march_transmittance(pos, sun_dir, rmo_extinction)
        step_scatter = mu.sum_last(rm_scattering * density[:, :2] * phase)
        in_scatter = in_scatter + step_scatter * sun_trans * visible * dd
        trans = trans * step_trans
        pos = pos + dd[:, None] * ray_dir
    return torch.where(active, in_scatter, 0.0), torch.where(active, trans, 1.0)


def ray_march_atmos(ray_pos, ray_dir, t_start, t_max, sun_dir, rmo_extinction,
                    rm_scattering, active):
    """The single-scatter march: the plain version for CPU tensors, the
    ``atmos_march`` kernel for CUDA tensors."""
    if ray_pos.device.type == "cpu":
        return ray_march_atmos_plain(ray_pos, ray_dir, t_start, t_max, sun_dir,
                                     rmo_extinction, rm_scattering, active)
    return kernels.atmos_march(
        ray_pos, ray_dir, t_start, t_max, sun_dir, rmo_extinction, rm_scattering,
        active, mie_e=C.MIE_ASYMMETRY,
    )


def _bounce_draws(keys, lane, tile: int):
    """The preview's random numbers for every bounce at once, (bounce,
    [cone, hemisphere], coordinate, n): per bounce the reference splits
    ``k_cone, k_hemi, key = jax.random.split(key, 3)`` (key i of a split is
    ``fold(key, i)``) and draws ``uniform(k, (2, tile))``, of which a lane
    reads flat indices ``lane`` and ``tile + lane``. Four threefry passes in
    all, where one per fold and draw would launch five times as many ops."""
    chain = [keys]
    for _ in range(_BOUNCES - 1):
        chain.append(rng.fold(chain[-1], 2))
    which = torch.tensor([0, 1], dtype=torch.int64, device=keys.device).view(1, 2, 1)
    sub = rng.fold(torch.stack(chain)[:, None], which)  # (bounce, 2, n, 2)
    return rng.uniform_at(sub[:, :, None], torch.stack([lane, tile + lane]))


def march_paths_plain(key, ray_pos, ray_dir, wavelength, scene: SceneParams, atlas, luts,
                      cfg: TraceConfig = TraceConfig(), tile_index=None, lane=None, tile=None):
    """Plain PyTorch twin of the ``preview`` kernel: the deterministic
    single-scatter radiance of one wavelength per lane (raymarcher.py:92).
    ``key`` (2,) is the tile key of one tile of ``n`` lanes, as the reference
    calls it, or the spp key with ``tile_index`` (n,) (each lane's tile),
    ``lane`` (n,) (its in-tile index) and ``tile`` (lanes per tile)."""
    n = ray_pos.shape[0]
    dev = ray_pos.device
    key = key.to(dev)
    if tile_index is None:
        keys, lane, tile = key.expand(n, 2), torch.arange(n, dtype=torch.int64, device=dev), n
    else:
        keys = rng.lane_keys(key, tile_index)
    draws = _bounce_draws(keys, lane, tile)
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
    )
    scattering = torch.stack(
        [ext_rmo[:, 0] * C.RAYLEIGH_ALBEDO, ext_rmo[:, 1] * C.AEROSOL_ALBEDO], dim=-1
    )
    light_direction = scene.light_direction.expand(n, 3)

    accum = torch.zeros((n,), device=dev)
    throughput = torch.ones((n,), device=dev)
    pos = ray_pos
    direction = ray_dir
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    primary_miss = torch.zeros((n,), dtype=torch.bool, device=dev)

    for bounce in range(_BOUNCES):
        u_cone, u_hemi = draws[bounce]
        earth = intersect_land(topo, pos, direction, scale, alive, cfg)
        a_near, a_far = mu.rsi(pos, direction, C.ATMOS_UPPER_LIMIT)
        t_start = torch.clamp(a_near, min=0.0)
        t_max = torch.where(earth > 0.0, earth, a_far)
        crosses = a_far >= 0.0
        if bounce == 0:
            primary_miss = primary_miss | (alive & ~crosses)
        alive = alive & crosses

        light_dir = smp.sample_cone_oriented(
            u_cone[0], u_cone[1], scene.sun_cos_angle, light_direction
        ).contiguous()
        in_scatter, trans = ray_march_atmos(
            pos, direction, t_start, t_max, light_dir, ext_rmo, scattering, alive
        )
        accum = accum + torch.where(alive, throughput * in_scatter, 0.0)
        throughput = torch.where(alive, throughput * trans, throughput)

        surface = alive & (earth > 0.0)
        earth_safe = torch.where(surface, earth, 0.0)
        land_pos = pos + earth_safe[:, None] * direction
        normal = land_normal(topo, land_pos, scale, cfg.bilinear_materials)
        albedo_srgb, ocean, bathymetry, emissive = get_land_material(
            atlas, land_pos, cfg.bilinear_materials
        )
        albedo = sp.srgb_to_spectrum(luts.srgb2spec, albedo_srgb, wavelength)
        accum = accum + torch.where(surface, throughput * emissive * nightlights_power, 0.0)
        offset_pos = land_pos * (1.0 + 0.0001 * scale / 12000.0)
        # the reference's shadow ray marches without any_hit (raymarcher.py:160)
        shadow = intersect_land(topo, offset_pos, light_dir, scale, surface, cfg)
        visible = (shadow < 0.0).to(torch.float32)
        d_brdf, d_ndl = srf.earth_brdf(albedo, ocean, bathymetry, -direction, normal, light_dir)
        accum = accum + torch.where(
            surface, throughput * visible * sun_irradiance * d_brdf * d_ndl, 0.0
        )
        hemi = smp.sample_hemisphere_cosine_weighted(u_hemi[0], u_hemi[1], normal)
        b_brdf, _ = srf.earth_brdf(albedo, ocean, bathymetry, -direction, normal, hemi)
        direction = torch.where(surface[:, None], hemi, direction).contiguous()
        pos = torch.where(surface[:, None], offset_pos, pos).contiguous()
        throughput = torch.where(surface, throughput * b_brdf * math.pi, throughput)
        alive = surface  # non-surface rays end after their march

    sun_hit = primary_miss & (mu.dot(light_direction, ray_dir) > scene.sun_cos_angle)
    accum = accum + torch.where(sun_hit, sun_power, 0.0)
    stars_srgb = tx.sample_dir_texture(atlas.stars, ray_dir, cfg.bilinear_materials)
    stars_power = sp.srgb_to_spectrum(luts.srgb2spec, stars_srgb, wavelength)
    accum = accum + torch.where(primary_miss, stars_power * sun_power * C.STARS_SCALE, 0.0)
    return torch.where(torch.isfinite(accum) & (accum >= 0.0), accum, 0.0)


class PreviewFrame:
    """The ``preview`` kernel's parameter blocks for a frame: the scene's
    scalars (``pathtracer.scene_floats``, the scene's host record), the
    march floor, the Planck and phase constants (floats), the march budget,
    the lanes per tile, the texture shapes and the march's options (ints),
    and ``cert_floor``, the uncertified floor of the certified floor (or
    None; ``kernels.preview`` takes it). Built from host values only, so it
    reads nothing from the card; the ``Renderer`` keeps one per scene,
    atlas, config and tile."""

    def __init__(self, scene: SceneParams, atlas, luts, cfg: TraceConfig, tile: int):
        topo = atlas.topography
        scale_f, light, cos_angle, solid_angle, offset_scale = scene_floats(scene)
        step_floor, stall_thresh, self.cert_floor = _march_floor(topo, cfg)
        self.fparams = [
            scale_f, step_floor, stall_thresh, *light, cos_angle, solid_angle, offset_scale,
            *sp.planck_kernel_constants(), C.SUN_TEMPERATURE, C.NIGHTLIGHT_TEMPERATURE,
            C.NIGHTLIGHT_SCALE, C.STARS_SCALE, C.RAYLEIGH_ALBEDO, C.AEROSOL_ALBEDO,
            *kernels.atmos_phase_constants(C.MIE_ASYMMETRY),
        ]
        self.iparams = [
            cfg.land_march_steps, cfg.march_k, cfg.march_stall_patience,
            int(cfg.bilinear_materials), tile, *topo.shape[:2], *atlas.material.shape[:2],
            *atlas.stars.shape[:2], *(int(getattr(cfg, name)) for name in kernels.MARCH_OPTIONS),
        ]


def march_paths(key, ray_pos, ray_dir, wavelength, scene: SceneParams, atlas, luts,
                cfg: TraceConfig = TraceConfig(), tile_index=None, lane=None, tile=None,
                frame: PreviewFrame = None, origin=None):
    """``march_paths_plain``'s function (same arguments): its plain version
    for CPU tensors, one launch of the ``preview`` kernel for CUDA tensors
    (``frame`` as built for the call, or built here). On the card
    ``ray_pos`` may be None with ``origin`` the lanes' shared origin, three
    float32 values on the host, which the kernel takes by value. ``key``
    should lie on the CPU: the kernel takes it as two integers."""
    if ray_dir.device.type == "cpu":
        return march_paths_plain(key, ray_pos, ray_dir, wavelength, scene, atlas, luts, cfg,
                                 tile_index, lane, tile)
    n = ray_dir.shape[0]
    if tile_index is None:
        tile = n
    if frame is None:
        frame = PreviewFrame(scene, atlas, luts, cfg, tile)
    return kernels.preview(
        frame.fparams, frame.iparams, key.tolist(), ray_pos, ray_dir, wavelength, tile_index,
        lane, atlas.topography, atlas.material, atlas.stars, luts.o3_crossec, luts.srgb2spec,
        origin=origin, cert_floor=frame.cert_floor,
    )
