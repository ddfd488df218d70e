"""Pinhole camera ray generation (port of digital_earth_tpu/render/camera.py:37)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.math_utils import cross, normalize


class CameraParams(NamedTuple):
    """Camera state as float32 tensors on the render device."""

    position: torch.Tensor  # (3,)
    look_at: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,) normalized
    fov: torch.Tensor  # vertical half-spread, radians
    aspect_scale: torch.Tensor


def cast_dirs(cam: CameraParams, u, v, u_jitter, v_jitter, image_res):
    """Jittered pinhole directions for pixel coords (u, v); u in [0, W),
    v in [0, H), with the reference's 1e-5 offsets and height-normalized
    film plane."""
    w, h = image_res
    aspect_ratio = w / h
    d = normalize(cam.look_at - cam.position)
    fu = (
        2.0 * cam.fov * (u + u_jitter) / h - cam.fov * aspect_ratio - 1e-5
    ) * cam.aspect_scale
    fv = 2.0 * cam.fov * (v + v_jitter) / h - cam.fov - 1e-5
    du = normalize(cross(d, cam.up))
    dv = normalize(cross(du, d))
    return normalize(d + fu[..., None] * du + fv[..., None] * dv)
