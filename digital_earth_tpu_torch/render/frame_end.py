"""The frame's end (port of digital_earth_tpu/render/renderer.py:343-348 and
the deposit of ``_render_selected``, 503-509): miss shading
(``pathtracer.shade_primary_miss``), the clamp (``finalize_radiance``), the
XYZ contraction, ``xyz_to_rgb`` and the add of each lane's RGB into its
pixel, with the adaptive pass's sample count and sum of squared luminance.

``frame_end_plain`` is the plain PyTorch version, ``frame_end`` the wrapper,
which launches the CUDA kernel ``frame_end`` (csrc/frame_end.cu) for a CUDA
render device. Path mode passes the wavefront after its last bounce
(``MissShading``); preview mode passes the radiance and the 1 / pdf of its
single wavelength and contracts ``(radiance * response) * pdf`` with no
shading or clamp, as the preview renderer's frame has it (renderer.py:212).

The lanes of one call hit distinct pixels (a frame, a chunk or a list of
distinct tiles), so the deposit needs no atomics and stays deterministic.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import constants as C
from .. import kernels
from ..assets.luts import SpectralLUTs
from ..assets.textures import TextureAtlas
from ..ops import math_utils as mu
from ..ops import spectral as sp
from . import pathtracer as pt
from .params import SceneParams, TraceConfig


class MissShading(NamedTuple):
    """Path mode's input: the wavefront after its last bounce and the scene
    it ran in, the arguments of ``pathtracer.shade_primary_miss``."""

    st: pt.TraceState
    scene: SceneParams
    atlas: TextureAtlas
    luts: SpectralLUTs
    cfg: TraceConfig


def frame_end_plain(responses, pid, color, count=None, lum2=None, *, miss=None,
                    radiance=None, pdf=None):
    """Plain PyTorch twin of the ``frame_end`` kernel: each lane's RGB added
    into ``color`` (P, 3) at pixel ``pid`` (distinct pixels), and with
    ``count``/``lum2`` (P,) one sample and its squared luminance there. Path
    mode passes ``miss``; preview mode ``radiance`` and ``pdf`` (n, 1)."""
    if miss is not None:
        radiance = pt.finalize_radiance(pt.shade_primary_miss(*miss))
        xyz = mu.sum_last(radiance[:, None, :] * responses.transpose(1, 2))
    else:
        xyz = radiance * responses[:, 0] * pdf
    rgb = sp.xyz_to_rgb(xyz)
    color[pid] += rgb
    if count is not None:
        lum = sp.lum(rgb)
        count[pid] += 1.0
        lum2[pid] += lum * lum


def _f32(x) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


@functools.lru_cache(maxsize=1)
def _kernel_floats():
    return (*sp.planck_kernel_constants(), _f32(C.SUN_TEMPERATURE), _f32(C.STARS_SCALE),
            *sp.XYZ_TO_RGB_D65.reshape(-1).tolist(), *sp.LUM_WEIGHTS.tolist())


def kernel_params(n_lambdas: int, miss=None):
    """The ``frame_end`` kernel's (17 float, 5 int) parameters."""
    fparams = list(_kernel_floats())
    if miss is None:
        return fparams, [n_lambdas, 0, 0, 1, 0]
    sh, sw = miss.atlas.stars.shape[:2]
    return fparams, [n_lambdas, sh, sw, 0, int(miss.cfg.bilinear_materials)]


def frame_end(responses, pid, color, count=None, lum2=None, *, miss=None, radiance=None,
              pdf=None):
    """Deposit a wavefront's lanes: the plain version for a CPU buffer, the
    ``frame_end`` kernel for a CUDA one."""
    if color.device.type == "cpu":
        return frame_end_plain(responses, pid, color, count, lum2, miss=miss,
                               radiance=radiance, pdf=pdf)
    shading = None
    if miss is not None:
        st = miss.st
        radiance = st.radiance
        shading = (st.throughput, st.w_mis, st.lambda_pdf, st.wavelength, st.direction,
                   st.primary_miss, miss.scene.light_direction, miss.scene.sun_cos_angle,
                   miss.atlas.stars, miss.luts.srgb2spec)
    fparams, iparams = kernel_params(radiance.shape[1], miss)
    kernels.frame_end(fparams, iparams, radiance.contiguous(), responses.contiguous(), pid,
                      color, count, lum2, pdf=pdf, miss=shading)
