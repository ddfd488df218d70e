"""Scene and trace parameters (port of digital_earth_tpu/render/params.py)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import constants as C


class SceneParams(NamedTuple):
    """Per-frame scene parameters (float32 tensors on the render device)."""

    light_direction: torch.Tensor  # (3,)
    sun_cos_angle: torch.Tensor
    sun_angular_radius: torch.Tensor
    land_height_scale: torch.Tensor


def make_scene_params(
    device,
    sun_angle: float = C.DEFAULT_SUN_ANGLE,
    sun_path_rot: float = C.DEFAULT_SUN_PATH_ROT,
    land_height_scale: float = C.DEFAULT_LAND_HEIGHT_SCALE,
) -> SceneParams:
    """Light direction from the two sun sliders (float32 trigonometry, as
    the reference evaluates it)."""
    f32 = dict(dtype=torch.float32, device=device)
    sun_angle = torch.tensor(sun_angle, **f32)
    sun_path_rot = torch.tensor(sun_path_rot, **f32)
    sun_rot = torch.stack([-torch.sin(sun_path_rot), torch.cos(sun_path_rot)])
    light_direction = torch.cat(
        [-torch.sin(sun_angle)[None], torch.cos(sun_angle) * sun_rot]
    )
    return SceneParams(
        light_direction=light_direction,
        sun_cos_angle=torch.tensor(C.SUN_COS_ANGLE, **f32),
        sun_angular_radius=torch.tensor(C.SUN_ANGULAR_RADIUS, **f32),
        land_height_scale=torch.tensor(land_height_scale, **f32),
    )


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """The trace budgets and estimator options the port implements; names
    and defaults are the reference's (digital_earth_tpu/render/params.py).

    The reference's other fields select TPU experiments, parity-bisection
    paths or TPU scheduling; the port implements each at its default.
    ``convert.trace_config`` carries a reference config across and rejects
    a non-default value of any of them that would change the image."""

    max_bounces: int = C.MAX_BOUNCES
    land_march_steps: int = C.LAND_MARCH_STEPS
    max_tracking_steps: int = 8192
    rr_start: int = C.RUSSIAN_ROULETTE_START
    bilinear_materials: bool = True
    tracking_k: int = 4
    march_k: int = 4
    march_floor_frac: float = 0.005
