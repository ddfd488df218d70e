"""Ray generation and wavelength sampling (port of ``gen_rays`` inside
digital_earth_tpu/render/renderer.py:160-194 ``_trace_tile_range``, with
render/camera.py:37 ``cast_dirs`` and ops/spectral.py:42, 88
``spectrum_sample`` / ``spectrum_sample_hero``): the plain PyTorch twin
``gen_rays_plain`` and the wrapper ``gen_rays``, which launches the CUDA
kernel ``gen_rays`` (csrc/gen_rays.cu) for a CUDA render device.

Lanes are numbered in tile-major order over (bw, bh) pixel blocks
(renderer.py:168-172, ``_tile_pixel_coords`` 469-480). The preview needs
that order, because its random draws are keyed by tile; the path tracer
keys every draw by pixel and runs its lanes in pixel order, which is the
same map with blocks of (1, H). An adaptive pass traces a list of tiles
(``tile_ids``, int32): lane ``l`` then lies in tile ``tile_ids[l // tile]``
(renderer.py:304 ``_trace_tile_range(..., tile_ids=)``).

The trace config picks the primary samples and the packet, as the
reference's: ``stratify_spp`` the R3 point under the pixel's
Cranley-Patterson shift, or (False) independent uniforms from the lane key
(renderer.py:176-191), in the path and the preview alike; ``hero_lambdas``
the path's packet width (the preview traces one wavelength).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..assets.luts import ray_tables
from ..ops import rng
from ..ops import spectral as sp
from .camera import CameraParams, HostCamera, camera_basis, cast_dirs
from .params import TraceConfig

# Frame-level RNG sites and the R3 rQMC constants (renderer.py:41-53).
_SITE_JITTER = 101
_SITE_WL = 102
_PIXEL_DOMAIN = 0x70697865
_R3_G = 1.2207440846057596
_R3_A32 = tuple(
    int(round((1.0 / _R3_G**i % 1.0) * 2**32)) & 0xFFFFFFFF for i in (1, 2, 3)
)


def pick_block_dims(w: int, h: int, target: int) -> Tuple[int, int]:
    """Near-square (bw, bh) with bw | w, bh | h and bw * bh <= target
    (renderer.py:56 ``_pick_block_dims``)."""
    divs_w = [d for d in range(1, w + 1) if w % d == 0]
    divs_h = [d for d in range(1, h + 1) if h % d == 0]
    best = (1, 1)
    best_score = -1.0
    for bw in divs_w:
        for bh in divs_h:
            n = bw * bh
            if n > target:
                continue
            score = n * (0.5 + 0.5 * min(bw, bh) / max(bw, bh))
            if score > best_score:
                best_score = score
                best = (bw, bh)
    return best


def tile_pixel_coords(lane, image_res, block, tile_ids=None):
    """(tile index, in-tile lane, pu, pv) of flat tile-major lane ids, the
    tiles taken from ``tile_ids`` when given."""
    _, h = image_res
    bw, bh = block
    tile = bw * bh
    nby = h // bh
    tidx, li = lane // tile, lane % tile
    if tile_ids is not None:
        tidx = tile_ids.to(torch.int64)[tidx]
    pu = (tidx // nby) * bw + li // bh
    pv = (tidx % nby) * bh + li % bh
    return tidx, li, pu, pv


class Rays(NamedTuple):
    """Per-lane output of ray generation. ``pdf`` is the hero packet's
    lambda pdf (L = ``hero_lambdas``), or 1 / pdf of the preview's single
    wavelength. The
    preview (keyed by tile) also gets each lane's tile and in-tile index."""

    keys: torch.Tensor         # (n, 2) int64 lane keys fold(spp_key, pid)
    dirs: torch.Tensor         # (n, 3)
    wavelengths: torch.Tensor  # (n, L)
    responses: torch.Tensor    # (n, L, 3)
    pdf: torch.Tensor          # (n, L)
    pid: torch.Tensor          # (n,) int64 pixel id pu * H + pv
    tile_index: Optional[torch.Tensor] = None  # (n,) int64, preview only
    lane_index: Optional[torch.Tensor] = None  # (n,) int64, preview only


def _seq(spp: int):
    """The R3 point of this spp, uint32 fixed point rounded to float32."""
    return [float(np.float32((a * (spp + 1)) & rng.M32)) * 2.0**-32 for a in _R3_A32]


@functools.lru_cache(maxsize=64)
def _host_key(k0: int, k1: int, data: int):
    """fold((k0, k1), data) on the host: the spp key, the pixel-domain key."""
    return tuple(rng.threefry2x32(k0, k1, 0, data & rng.M32))


def spp_key(base_key, spp: int):
    """The spp key fold(base_key, spp) on the host, as a (2,) int64 CPU
    tensor (the preview kernel takes it as two integers): Python integer
    arithmetic, where ``rng.fold`` on a CPU tensor runs threefry as some
    hundred small tensor operations."""
    return torch.tensor(_host_key(base_key[0], base_key[1], spp), dtype=torch.int64)


@functools.lru_cache(maxsize=16)
def _camera_floats(host: HostCamera, w: int, h: int):
    """The kernel's camera floats: the basis in float32 on the CPU (as the
    twin computes it), 2 fov, fov, fov * aspect and the aspect scale."""
    d, du, dv = camera_basis(host.params("cpu"))
    fov = np.float32(host.fov)
    return (*d.tolist(), *du.tolist(), *dv.tolist(), float(np.float32(2.0) * fov), float(fov),
            float(fov * np.float32(w / h)), host.aspect_scale)


def gen_rays_plain(base_key, spp: int, lane0: int, n: int, image_res, block,
                   cam: CameraParams, luts, preview: bool, tile_ids=None,
                   cfg: TraceConfig = TraceConfig()) -> Rays:
    """Plain PyTorch twin of the ``gen_rays`` kernel for lanes
    [lane0, lane0 + n); ``base_key`` is the frame key as two ints."""
    _, h = image_res
    dev = luts.cie_cdf.device
    lane = torch.arange(lane0, lane0 + n, dtype=torch.int64, device=dev)
    tidx, li, pu_i, pv_i = tile_pixel_coords(lane, image_res, block, tile_ids)
    pid = pu_i * h + pv_i
    base = torch.tensor(base_key, dtype=torch.int64, device=dev)
    keys = rng.lane_keys(rng.fold(base, spp), pid)
    if cfg.stratify_spp:
        pkeys = rng.lane_keys(rng.fold(base, _PIXEL_DOMAIN), pid)
        shift = rng.uniform(rng.fold(pkeys, _SITE_JITTER), (3,))
        seq = torch.tensor(_seq(spp), dtype=torch.float32, device=dev)
        u3 = torch.remainder(shift + seq[:, None], 1.0)
    else:
        u3 = torch.cat([rng.uniform(rng.fold(keys, _SITE_JITTER), (2,)),
                        rng.uniform(rng.fold(keys, _SITE_WL), (1,))])
    cpu_cam = cam.host.params("cpu")
    basis = tuple(t.to(dev) for t in camera_basis(cpu_cam))
    dirs = cast_dirs(cpu_cam, pu_i.to(torch.float32), pv_i.to(torch.float32),
                     u3[0], u3[1], image_res, basis)
    if preview:
        wl, resp, rcp_pdf = sp.spectrum_sample(u3[2], luts.cie_cdf, luts.cie_response)
        return Rays(keys, dirs, wl[:, None], resp[:, None, :], rcp_pdf[:, None], pid, tidx, li)
    wl, resp, pdf = sp.spectrum_sample_hero(
        u3[2], luts.cie_cdf, luts.cie_response, cfg.hero_lambdas
    )
    return Rays(keys, dirs, wl, resp, pdf, pid)


def kernel_params(base_key, spp: int, lane0: int, image_res, block,
                  cam: CameraParams, luts, preview: bool, cfg: TraceConfig = TraceConfig()):
    """The ``gen_rays`` kernel's (19 float, 13 int) parameters from host
    values alone: the camera's ``host`` floats (its basis computed once in
    float32 on the CPU), the CIE CDF's totals recorded with ``luts``
    (assets/luts.ray_tables), the keys derived on the host, the packet width
    and the primary samples' mode from ``cfg``. Reads no tensor."""
    w, h = image_res
    _, cdf_max = ray_tables(luts)
    fparams = [*_camera_floats(cam.host, w, h), *_seq(spp), *cdf_max]
    k0, k1 = base_key
    iparams = [*_host_key(k0, k1, spp), *_host_key(k0, k1, _PIXEL_DOMAIN), lane0, w, h,
               block[0], block[1], luts.cie_cdf.shape[0], 1 if preview else cfg.hero_lambdas,
               int(preview), int(cfg.stratify_spp)]
    return fparams, iparams


def gen_rays(base_key, spp: int, lane0: int, n: int, image_res, block,
             cam: CameraParams, luts, preview: bool, tile_ids=None,
             cfg: TraceConfig = TraceConfig()) -> Rays:
    """Rays for lanes [lane0, lane0 + n) (of the tiles ``tile_ids`` when
    given) under ``cfg``'s primary samples and packet width: the plain
    version on a CPU render device, the ``gen_rays`` kernel on a CUDA one,
    which reads nothing back from the card."""
    if luts.cie_cdf.device.type == "cpu":
        return gen_rays_plain(base_key, spp, lane0, n, image_res, block, cam, luts, preview,
                              tile_ids, cfg)
    fparams, iparams = kernel_params(base_key, spp, lane0, image_res, block, cam, luts, preview,
                                     cfg)
    g, _ = ray_tables(luts)
    return Rays(*kernels.gen_rays(
        fparams, iparams, g, luts.cie_response, n, iparams[10], tile_ids, tile_map=preview,
    ))
