"""Progressive spectral renderer (port of digital_earth_tpu/render/renderer.py):
``set_*`` setters, ``accumulate()`` (one spp), ``accumulate_interruptible``
(one spp in chunks, with an interrupt poll between chunks and bounces),
``fetch_image()`` / ``fetch_image_np()`` (the film chain), ``reset_framebuffer()``,
``save_checkpoint`` / ``load_checkpoint`` (the reference's file format).

``mode="path"`` is the spectral path tracer, ``mode="preview"`` the
deterministic single-scatter raymarcher (render/raymarcher.py).

Schedule: the reference traces pixel blocks and compacts lane tiles
between bounce windows for the TPU; its path-traced output does not depend
on that layout, because every lane's randomness is keyed by its global
pixel id (ops/rng.py). Here a frame, or a chunk of it, is one wavefront of
lanes: rays for every lane, one bounce at a time over the live lanes
(pathtracer.run_bounces), then each lane's radiance lands in the (W, H, 3)
buffer at its pixel. The preview keys its draws by pixel tile, so its lanes
follow the reference's tile-major order (render/raygen.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import constants as C

from ..assets.luts import CRFPack, SpectralLUTs, load_crf_pack, load_spectral_luts
from ..assets.textures import TextureAtlas, load_texture_atlas
from ..ops import math_utils as mu
from ..ops import rng
from ..ops import spectral as sp
from . import film
from . import pathtracer as pt
from . import raygen
from . import raymarcher
from .camera import CameraParams
from .params import SceneParams, TraceConfig, make_scene_params

ADAPTIVE_TODO = (
    "adaptive sampling (per-pixel counts) is not ported yet: ROADMAP.md, "
    "queue A #10 and B #13"
)


def trace_lanes(base_key, spp: int, lane0: int, n: int, cam: CameraParams,
                scene: SceneParams, atlas: TextureAtlas, luts: SpectralLUTs,
                image_res, block, cfg: TraceConfig, mode: str = "path", interrupt=None):
    """One sample for lanes [lane0, lane0 + n) of the frame's tile-major
    lane order over ``block``: (pid (n,), linear RGB (n, 3)), pid = pu * H + pv
    (renderer.py:125-348; the preview branch is render_tile, 202-213). The
    path tracer polls ``interrupt`` between bounces (pathtracer.run_bounces)."""
    _, h = image_res
    preview = mode == "preview"
    rays = raygen.gen_rays(base_key, spp, lane0, n, image_res, block, cam, luts, preview)
    dev = rays.dirs.device
    lane = torch.arange(lane0, lane0 + n, dtype=torch.int64, device=dev)
    tidx, li, pu, pv = raygen.tile_pixel_coords(lane, image_res, block)
    pos = cam.position.expand(n, 3).contiguous()
    if preview:
        spp_key = rng.fold(torch.tensor(base_key, dtype=torch.int64, device=dev), spp)
        radiance = raymarcher.march_paths(
            rng.lane_keys(spp_key, tidx), pos, rays.dirs, rays.wavelengths[:, 0],
            scene, atlas, luts, cfg, lane=li, tile=block[0] * block[1],
        )
        xyz = radiance[:, None] * rays.responses[:, 0] * rays.pdf
    else:
        st = pt.init_state(pos, rays.dirs, rays.wavelengths, rays.pdf, rays.keys)
        st = pt.run_bounces(st, scene, atlas, luts, cfg, 0, 1, interrupt)
        st = pt.shade_primary_miss(st, scene, atlas, luts, cfg)
        st = pt.run_bounces(st, scene, atlas, luts, cfg, 1, cfg.max_bounces, interrupt)
        radiance = pt.finalize_radiance(st)
        xyz = mu.sum_last(radiance[:, None, :] * rays.responses.transpose(1, 2))
    return pu * h + pv, sp.xyz_to_rgb(xyz)


class Renderer:
    """Progressive spectral renderer on an explicit ``device``."""

    def __init__(
        self,
        device,
        image_res: Tuple[int, int] = (1920, 1080),
        up=(0.0, 1.0, 0.0),
        atlas: Optional[TextureAtlas] = None,
        luts: Optional[SpectralLUTs] = None,
        crf: Optional[CRFPack] = None,
        tile_pixels: int = 2048,
        seed: int = 0,
        cfg: TraceConfig = TraceConfig(),
        drt: str = "opendrt",
        mode: str = "path",
    ):
        if mode not in ("path", "preview"):
            raise ValueError(f"unknown render mode {mode!r}")
        self.device = torch.device(device)
        self.image_res = tuple(image_res)
        self.cfg = cfg
        self.drt = drt
        self.mode = mode
        self.atlas = atlas if atlas is not None else load_texture_atlas(self.device)
        self.luts = luts if luts is not None else load_spectral_luts(self.device)
        self.crf = crf if crf is not None else load_crf_pack(self.device)
        self.crf_names = list(self.crf.names)
        self.block = raygen.pick_block_dims(image_res[0], image_res[1], tile_pixels)
        self.tile = self.block[0] * self.block[1]

        self.camera_pos = np.zeros(3, dtype=np.float64)
        self.look_at = np.zeros(3, dtype=np.float64)
        self.up = np.asarray(up, dtype=np.float64)
        self.up /= np.linalg.norm(self.up)
        self.fov = C.DEFAULT_FOV
        self.aspect_scale = 1.0
        self.exposure = C.DEFAULT_EXPOSURE
        self.gamma = C.DEFAULT_GAMMA
        self.selected_crf = 0
        self.sun_angle = C.DEFAULT_SUN_ANGLE
        self.sun_path_rot = C.DEFAULT_SUN_PATH_ROT
        self.land_height_scale = C.DEFAULT_LAND_HEIGHT_SCALE

        self._seed_key = (0, int(seed) & rng.M32)  # jax.random.PRNGKey(seed)
        self.current_spp = 0
        self.total_samples = 0
        self._rng_round = 0
        self._adaptive_rounds = 0
        self.color_buffer = torch.zeros(
            (image_res[0], image_res[1], 3), dtype=torch.float32, device=self.device
        )

    # --- setters ------------------------------------------------------------
    def set_camera_pos(self, x, y, z):
        self.camera_pos = np.array([x, y, z], dtype=np.float64)

    def set_look_at(self, x, y, z):
        self.look_at = np.array([x, y, z], dtype=np.float64)

    def set_up(self, x, y, z):
        up = np.array([x, y, z], dtype=np.float64)
        self.up = up / np.linalg.norm(up)

    def set_fov(self, fov):
        self.fov = float(fov)

    def set_aspect_scale(self, scale):
        self.aspect_scale = float(scale)

    def set_exposure(self, exposure):
        self.exposure = float(exposure)

    def set_gamma(self, gamma):
        self.gamma = float(gamma)

    def set_crf(self, index):
        self.selected_crf = int(index)

    def set_sun_angle(self, ang):
        self.sun_angle = float(ang)

    def set_sun_path_rot(self, ang):
        self.sun_path_rot = float(ang)

    def set_land_height_scale(self, scale):
        self.land_height_scale = float(scale)

    # --- parameter assembly -------------------------------------------------
    def camera_params(self) -> CameraParams:
        f32 = dict(dtype=torch.float32, device=self.device)
        return CameraParams(
            position=torch.tensor(self.camera_pos, **f32),
            look_at=torch.tensor(self.look_at, **f32),
            up=torch.tensor(self.up, **f32),
            fov=torch.tensor(self.fov, **f32),
            aspect_scale=torch.tensor(self.aspect_scale, **f32),
        )

    def scene_params(self) -> SceneParams:
        return make_scene_params(
            self.device, self.sun_angle, self.sun_path_rot, self.land_height_scale
        )

    # --- main API -----------------------------------------------------------
    def reset_framebuffer(self):
        self.current_spp = 0
        self.total_samples = 0
        self._rng_round = 0
        self._adaptive_rounds = 0
        self.color_buffer.zero_()

    @property
    def mean_spp(self) -> float:
        """Average samples per pixel (== current_spp without adaptive passes)."""
        return self.total_samples / (self.image_res[0] * self.image_res[1])

    def accumulate(self):
        """Trace one sample per pixel into the accumulation buffer."""
        self.accumulate_interruptible(1)

    def accumulate_interruptible(self, n_chunks: int, interrupt=None) -> bool:
        """Trace one spp in ``n_chunks`` contiguous lane ranges (pixel ids
        in path mode), calling ``interrupt()`` between chunks once the device
        has finished the chunk, and in path mode between bounces too; abort,
        discarding the partial spp, when it returns True. Returns whether the
        spp completed (renderer.py:719; the reference polls between chunks
        only).

        Every lane's randomness depends on its pixel (its tile in preview
        mode) and the round only, so the spp does not depend on the cut:
        bit-identical to ``accumulate()`` on the card."""
        w, h = self.image_res
        total = w * h
        per = -(-total // max(1, min(int(n_chunks), total)))
        block = self.block if self.mode == "preview" else (1, h)
        cam, scene = self.camera_params(), self.scene_params()
        # only an abortable spp needs a staging buffer: an abort must leave
        # the accumulation buffer as it was
        out = (self.color_buffer.view(total, 3) if interrupt is None
               else torch.zeros((total, 3), dtype=torch.float32, device=self.device))
        for lo in range(0, total, per):
            n = min(per, total - lo)
            try:
                pid, rgb = trace_lanes(
                    self._seed_key, self._rng_round, lo, n, cam, scene, self.atlas,
                    self.luts, self.image_res, block, self.cfg, self.mode, interrupt,
                )
            except pt.Interrupted:
                return False
            if self.mode == "path":
                out[lo:lo + n] += rgb  # (1, H) blocks: lane == pixel id
            else:
                out[pid] += rgb  # tile-major lanes, distinct pixel ids
            if interrupt is not None and lo + n < total:
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()  # releases the GIL
                if interrupt():
                    return False
        if interrupt is not None:
            self.color_buffer += out.view(w, h, 3)
        self.current_spp += 1
        self._rng_round += 1
        self.total_samples += total
        return True

    def fetch_image(self):
        """Post-processed (W, H, 3) float sRGB."""
        return film.postprocess(
            self.color_buffer, float(self.current_spp), self.exposure,
            self.gamma, self.crf.curves, self.selected_crf, self.drt,
        )

    def fetch_image_u8(self):
        """(H, W, 3) uint8 on the render device, row 0 at top."""
        img = (torch.clamp(self.fetch_image(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        return img.transpose(0, 1).flip(0)

    def fetch_image_np(self) -> np.ndarray:
        """(H, W, 3) uint8, row 0 at top."""
        return self.fetch_image_u8().cpu().numpy()

    # --- render-state checkpoints (renderer.py:812-853) ----------------------
    def save_checkpoint(self, path: str):
        """Write the resumable render state in the reference's file format."""
        np.savez_compressed(
            path,
            color_buffer=self.color_buffer.cpu().numpy(),
            current_spp=self.current_spp,
            seed_key=np.asarray(self._seed_key, dtype=np.uint32),
            rng_round=self._rng_round,
            adaptive_rounds=self._adaptive_rounds,
            total_samples=self.total_samples,
        )

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint written by either renderer."""
        with np.load(path) as z:
            if "count_buffer" in z:
                raise NotImplementedError(f"checkpoint {path} holds per-pixel counts: {ADAPTIVE_TODO}")
            buf = z["color_buffer"]
            if buf.shape != (*self.image_res, 3):
                raise ValueError(f"checkpoint buffer {buf.shape}, renderer {(*self.image_res, 3)}")
            self.color_buffer = torch.as_tensor(buf, dtype=torch.float32).to(self.device)
            self.current_spp = int(z["current_spp"])
            self._seed_key = tuple(int(k) for k in z["seed_key"])
            # pre-adaptive checkpoints carry no round counters
            self._rng_round = int(z["rng_round"]) if "rng_round" in z else self.current_spp
            self._adaptive_rounds = int(z["adaptive_rounds"]) if "adaptive_rounds" in z else 0
            self.total_samples = (
                int(z["total_samples"]) if "total_samples" in z
                else self.current_spp * self.image_res[0] * self.image_res[1]
            )
