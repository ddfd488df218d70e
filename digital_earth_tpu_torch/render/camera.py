"""Pinhole camera ray generation (port of digital_earth_tpu/render/camera.py:37)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.math_utils import cross, normalize


class HostCamera(NamedTuple):
    """The camera as the host holds it: Python floats, each a float32 value."""

    position: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    up: Tuple[float, float, float]
    fov: float
    aspect_scale: float

    @staticmethod
    def of(position, look_at, up, fov, aspect_scale) -> "HostCamera":
        """Round float64 values (sequences, scalars) to float32 as
        ``torch.tensor(..., dtype=torch.float32)`` does."""
        def f32(x):
            return torch.tensor(x, dtype=torch.float64).to(torch.float32).tolist()
        return HostCamera(tuple(f32(position)), tuple(f32(look_at)), tuple(f32(up)),
                          f32(fov), f32(aspect_scale))

    def params(self, device) -> "CameraParams":
        """The float32 tensors of this camera on ``device``."""
        f32 = dict(dtype=torch.float32, device=device)
        return CameraParams(
            position=torch.tensor(self.position, **f32),
            look_at=torch.tensor(self.look_at, **f32),
            up=torch.tensor(self.up, **f32),
            fov=torch.tensor(self.fov, **f32),
            aspect_scale=torch.tensor(self.aspect_scale, **f32),
            host=self,
        )


class CameraParams(NamedTuple):
    """Camera state as float32 tensors on the render device, and ``host``,
    the same values as the host holds them (what ray generation and the
    rays' origin read, so that neither reads the card)."""

    position: torch.Tensor  # (3,)
    look_at: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,) normalized
    fov: torch.Tensor  # vertical half-spread, radians
    aspect_scale: torch.Tensor
    host: HostCamera


def camera_basis(cam: CameraParams):
    """(forward, right, up) unit vectors of the film plane."""
    d = normalize(cam.look_at - cam.position)
    du = normalize(cross(d, cam.up))
    dv = normalize(cross(du, d))
    return d, du, dv


def cast_dirs(cam: CameraParams, u, v, u_jitter, v_jitter, image_res, basis=None):
    """Jittered pinhole directions for pixel coords (u, v); u in [0, W),
    v in [0, H), with the reference's 1e-5 offsets and height-normalized
    film plane. ``basis`` is ``camera_basis(cam)``, computed here if absent."""
    w, h = image_res
    aspect_ratio = w / h
    d, du, dv = camera_basis(cam) if basis is None else basis
    fu = (
        2.0 * cam.fov * (u + u_jitter) / h - cam.fov * aspect_ratio - 1e-5
    ) * cam.aspect_scale
    fv = 2.0 * cam.fov * (v + v_jitter) / h - cam.fov - 1e-5
    return normalize(d + fu[..., None] * du + fv[..., None] * dv)
