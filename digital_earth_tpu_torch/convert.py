"""Carry the JAX package's state over to the port.

Inputs are the JAX package's objects read through ``numpy.asarray`` (or
plain numpy arrays): this module never imports ``jax``.

- a ``Tex2D`` row-gather texture (``rows`` (n_rows, 128) plus ``h``, ``w``,
  ``channels``; texel t's channel c at rows[t // tpr, (t % tpr) * C + c],
  tpr = 128 // C, padding lanes past tpr * C) -> uint8 (H, W, C) tensor;
- a ``TextureAtlas`` of four Tex2D -> the port's TextureAtlas;
- ``SpectralLUTs`` / ``CRFPack`` -> the port's tensor versions;
- ``SceneParams`` / ``CameraParams`` -> the port's versions;
- a ``TraceConfig`` -> the port's ``TraceConfig`` (``trace_config``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .assets.luts import CRFPack, SpectralLUTs
from .assets.textures import TextureAtlas
from .render.camera import CameraParams, HostCamera
from .render.params import SCENE_TENSORS, SceneParams, TraceConfig, scene_params

LANES = 128


def tex2d_array(rows, h: int, w: int, channels: int) -> np.ndarray:
    """Unpack a row-gather texture into its (H, W, C) image."""
    rows = np.asarray(rows)
    tpr = LANES // channels
    texels = rows[:, : tpr * channels].reshape(-1, channels)
    return texels[: h * w].reshape(h, w, channels).copy()


def tex2d_to_tensor(tex, device) -> torch.Tensor:
    """A Tex2D-like object (``rows``, ``h``, ``w``, ``channels``) -> (H, W, C)."""
    return torch.from_numpy(tex2d_array(tex.rows, tex.h, tex.w, tex.channels)).to(device)


def atlas_to_torch(atlas, device) -> TextureAtlas:
    return TextureAtlas(**{
        name: tex2d_to_tensor(getattr(atlas, name), device)
        for name in TextureAtlas._fields
    })


def _f32(a, device):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def spectral_luts_to_torch(luts, device) -> SpectralLUTs:
    return SpectralLUTs(*(_f32(getattr(luts, f), device) for f in SpectralLUTs._fields))


def crf_pack_to_torch(crf, device) -> CRFPack:
    return CRFPack(curves=_f32(crf.curves, device), names=tuple(crf.names))


def scene_params_to_torch(scene, device) -> SceneParams:
    """The reference's scene as float32 tensors on ``device``, with the host
    record the kernels' parameter blocks read (computed there, read once)."""
    return scene_params(*(_f32(getattr(scene, f), device) for f in SCENE_TENSORS))


def camera_params_to_torch(cam, device) -> CameraParams:
    return HostCamera.of(*(np.asarray(getattr(cam, f), np.float64)
                           for f in HostCamera._fields)).params(device)


def trace_config(ref) -> TraceConfig:
    """The port's ``TraceConfig`` for the reference's ``TraceConfig``.

    The port implements every other reference field at its default, so a
    non-default value of one raises ``ValueError``. The exceptions are the
    TPU scheduling fields ``compact_*``: they partition the work across
    tiles and do not change the image."""
    kept = {f.name for f in dataclasses.fields(TraceConfig)}
    for f in dataclasses.fields(ref):
        value = getattr(ref, f.name)
        if f.name in kept or f.name.startswith("compact_") or value == f.default:
            continue
        raise ValueError(
            f"TraceConfig.{f.name}={value!r}: the PyTorch port implements "
            f"only the default {f.default!r}"
        )
    return TraceConfig(**{name: getattr(ref, name) for name in kept})
