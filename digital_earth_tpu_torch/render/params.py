"""Scene and trace parameters (port of digital_earth_tpu/render/params.py)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .. import constants as C
from ..ops import math_utils as mu


class HostScene(NamedTuple):
    """The scene's kernel scalars as the host holds them, Python floats each
    a float32 value: what the kernels' parameter blocks take
    (``pathtracer.scene_floats``), so that building them reads nothing from
    the card."""

    land_height_scale: float
    light_direction: Tuple[float, float, float]
    sun_cos_angle: float
    solid_angle: float  # of the sun's cone
    offset_scale: float  # 1 + 1e-4 scale / 12000, the surface offset factor


class SceneParams(NamedTuple):
    """Per-frame scene parameters: float32 tensors on the render device, and
    ``host``, the kernels' scalars derived from them (``host_scene``)."""

    light_direction: torch.Tensor  # (3,)
    sun_cos_angle: torch.Tensor
    sun_angular_radius: torch.Tensor
    land_height_scale: torch.Tensor
    host: HostScene


SCENE_TENSORS = SceneParams._fields[:4]  # the fields the reference's SceneParams has


def host_scene(light_direction, sun_cos_angle, sun_angular_radius, land_height_scale):
    """The ``HostScene`` of the scene tensors, computed by the twins' own
    float32 arithmetic on the tensors' device (the solid angle of the sun's
    cone, the offset factor; PyTorch on the card applies a Python divisor as
    a multiply by float32(1 / b), so the device decides the bits) and read
    back with one ``.tolist()``: the one read of the card per scene."""
    scale = land_height_scale
    scale_f, *light, cos_angle, solid_angle, offset_scale = torch.stack([
        scale, *light_direction, sun_cos_angle,
        mu.cone_angle_to_solid_angle(sun_angular_radius), 1.0 + 0.0001 * scale / 12000.0,
    ]).tolist()
    return HostScene(scale_f, tuple(light), cos_angle, solid_angle, offset_scale)


def scene_params(light_direction, sun_cos_angle, sun_angular_radius,
                 land_height_scale) -> SceneParams:
    """``SceneParams`` of the four scene tensors, with their host record."""
    tensors = (light_direction, sun_cos_angle, sun_angular_radius, land_height_scale)
    return SceneParams(*tensors, host=host_scene(*tensors))


def make_scene_params(
    device,
    sun_angle: float = C.DEFAULT_SUN_ANGLE,
    sun_path_rot: float = C.DEFAULT_SUN_PATH_ROT,
    land_height_scale: float = C.DEFAULT_LAND_HEIGHT_SCALE,
) -> SceneParams:
    """Light direction from the two sun sliders (float32 trigonometry, as
    the reference evaluates it); the host record is read once, here."""
    f32 = dict(dtype=torch.float32, device=device)
    sun_angle = torch.tensor(sun_angle, **f32)
    sun_path_rot = torch.tensor(sun_path_rot, **f32)
    sun_rot = torch.stack([-torch.sin(sun_path_rot), torch.cos(sun_path_rot)])
    light_direction = torch.cat(
        [-torch.sin(sun_angle)[None], torch.cos(sun_angle) * sun_rot]
    )
    return scene_params(
        light_direction,
        torch.tensor(C.SUN_COS_ANGLE, **f32),
        torch.tensor(C.SUN_ANGULAR_RADIUS, **f32),
        torch.tensor(land_height_scale, **f32),
    )


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """The trace budgets and estimator options the port implements; names
    and defaults are the reference's (digital_earth_tpu/render/params.py).

    ``hero_lambdas``, ``stratify_spp`` and ``analytic_transmittance`` at
    1, False and False make up the reference's own estimator: single
    wavelength paths, independent uniform primary samples, and ratio
    tracking of the gases' sun transmittance in place of the closed form.
    ``hero_lambdas`` takes any packet width of at least 1, as the reference
    does: the kernels' main library holds widths 1 and 4, and each other
    width runs from a library of its own, built at its first use
    (``kernels.width_library``).

    The scene and march options (``SCENE_OPTIONS``) change the image:
    ``enable_clouds`` and ``enable_land`` take the cloud slab and the
    terrain out of the scene; ``bilinear_tracking`` filters the march's and
    the cloud trackers' in-loop taps (and the lazy march's origin tap)
    bilinearly, as the original renderer filters everything;
    ``lazy_march`` False marches before the flight (the reference's order)
    instead of on demand after it; ``march_exact_ocean``,
    ``march_ref_phantom`` and ``march_stall_patience`` are the march's
    exact ocean root, its phantom crawl and its stall patience. At any of
    the six flags off its default the kernels run their options instances;
    every instance takes the stall patience at run time.

    The estimator options (``ESTIMATOR_OPTIONS``) keep the image's
    expectation and change how it is sampled: ``analytic_flight`` draws the
    gases' free flight by inverting their optical depth on the density
    table with ``flight_newton_iters`` safeguarded Newton steps, in place of
    delta tracking; ``fast_loop_rng`` draws the accelerated trackers'
    in-loop uniforms from a counter hash in place of threefry;
    ``nee_rr_prob`` below 1 keeps the sun's shadow track past bounce
    ``nee_rr_start`` with that probability, and ``cloud_rr_keep`` below 1 a
    cloud-scattered path from bounce ``cloud_rr_start`` on, each reweighted;
    ``nee_off`` drops the sun's next-event estimate (a diagnostic: the image
    darkens). At any of them off its default the bounce kernels run their
    options instances.

    The march floors (``FLOOR_OPTIONS``) change where the land march may
    step over terrain: ``march_certified_floor`` steps a probe by the floor
    (``march_floor_frac`` of a texel arc) only where the hop provably clears
    a regional bound sphere, and by ``march_uncert_floor_frac`` of a texel
    arc elsewhere; ``march_floor_frac_secondary``, when set, is the floor of
    the bounce's primary marches past bounce 0 (the shadow march and the
    preview keep ``march_floor_frac``; the naive marches have no floor). At
    the certified floor or a secondary floor the bounce kernels run their
    floor instances (which also take the estimator options), and at the
    certified floor the march and preview kernels theirs;
    ``march_uncert_floor_frac`` alone changes nothing.

    The reference's other fields select TPU experiments, parity-bisection
    paths or TPU scheduling; the port implements each at its default.
    ``convert.trace_config`` carries a reference config across and rejects
    a non-default value of any of them that would change the image."""

    max_bounces: int = C.MAX_BOUNCES
    land_march_steps: int = C.LAND_MARCH_STEPS
    max_tracking_steps: int = 8192
    enable_clouds: bool = True
    enable_land: bool = True
    rr_start: int = C.RUSSIAN_ROULETTE_START
    bilinear_tracking: bool = False
    bilinear_materials: bool = True
    tracking_k: int = 4
    march_k: int = 4
    march_floor_frac: float = 0.005
    march_ref_phantom: bool = True
    hero_lambdas: int = 4
    stratify_spp: bool = True
    analytic_transmittance: bool = True
    march_exact_ocean: bool = True
    march_stall_patience: int = 2
    lazy_march: bool = True
    naive_tracking: bool = False
    naive_march: bool = False
    naive_cloud_tracking: bool = False
    naive_shadow: bool = False
    analytic_flight: bool = False
    flight_newton_iters: int = 14
    fast_loop_rng: bool = False
    nee_rr_start: int = C.MULTISCATTER_BOUNCE
    nee_rr_prob: float = 1.0
    cloud_rr_start: int = C.MULTISCATTER_BOUNCE
    cloud_rr_keep: float = 1.0
    nee_off: bool = False
    march_floor_frac_secondary: "float | None" = None
    march_certified_floor: bool = False
    march_uncert_floor_frac: float = 0.005

    def __post_init__(self):
        if int(self.hero_lambdas) != self.hero_lambdas or self.hero_lambdas < 1:
            raise ValueError(
                f"TraceConfig.hero_lambdas={self.hero_lambdas!r}: a packet of at least one "
                "wavelength"
            )
        if self.naive_tracking and self.hero_lambdas != 1:
            raise ValueError(
                f"TraceConfig.naive_tracking with hero_lambdas={self.hero_lambdas!r}: the naive "
                "trackers are single-wavelength (hero_lambdas=1)"
            )
        for name in ("nee_rr_prob", "cloud_rr_keep"):
            if not 0.0 < getattr(self, name) <= 1.0:
                raise ValueError(f"TraceConfig.{name}={getattr(self, name)!r}: a probability in "
                                 "(0, 1]")
        for name in ("march_floor_frac", "march_uncert_floor_frac", "march_floor_frac_secondary"):
            value = getattr(self, name)
            if value is not None and not value > 0.0:
                raise ValueError(f"TraceConfig.{name}={value!r}: a fraction of a texel arc above 0")
        if self.flight_newton_iters < 0:
            raise ValueError(f"TraceConfig.flight_newton_iters={self.flight_newton_iters!r}: "
                             "a count of steps")

    def options(self) -> dict:
        """The scene and march options that differ from their defaults."""
        return {name: getattr(self, name) for name, default in SCENE_OPTIONS.items()
                if getattr(self, name) != default}


# The scene and march options with their (the reference's) defaults: the
# bounce, march and preview kernels run their options instances when a flag
# among them differs (every instance takes the stall patience).
SCENE_OPTIONS = {name: TraceConfig.__dataclass_fields__[name].default for name in (
    "enable_clouds", "enable_land", "bilinear_tracking", "lazy_march", "march_exact_ocean",
    "march_ref_phantom", "march_stall_patience")}

# The reference-faithful naive arm's flags with their (the reference's)
# defaults: at any of them the bounce kernels run their options instances.
NAIVE_OPTIONS = {name: TraceConfig.__dataclass_fields__[name].default for name in (
    "naive_tracking", "naive_march", "naive_cloud_tracking", "naive_shadow")}

# The estimator options with their (the reference's) defaults: at any of
# them off its default the bounce kernels run their options instances.
ESTIMATOR_OPTIONS = {name: TraceConfig.__dataclass_fields__[name].default for name in (
    "analytic_flight", "flight_newton_iters", "fast_loop_rng", "nee_rr_start", "nee_rr_prob",
    "cloud_rr_start", "cloud_rr_keep", "nee_off")}

# The march floors with their (the reference's) defaults: at the certified
# floor or a secondary floor the bounce kernels run their floor instances,
# and at the certified floor the march and preview kernels theirs.
FLOOR_OPTIONS = {name: TraceConfig.__dataclass_fields__[name].default for name in (
    "march_certified_floor", "march_uncert_floor_frac", "march_floor_frac_secondary")}
