"""Progressive spectral renderer (port of digital_earth_tpu/render/renderer.py):
``set_*`` setters, ``accumulate()`` (one spp), ``accumulate_interruptible``
(one spp in chunks, with an interrupt poll between chunks and bounces),
``accumulate_adaptive`` (one pass over the noisiest tiles),
``fetch_image()`` / ``fetch_image_np()`` (the film chain), ``reset_framebuffer()``,
``save_checkpoint`` / ``load_checkpoint`` (the reference's file format).

``mode="path"`` is the spectral path tracer, ``mode="preview"`` the
deterministic single-scatter raymarcher (render/raymarcher.py).

Schedule: the reference traces pixel blocks and compacts lane tiles
between bounce windows for the TPU; its path-traced output does not depend
on that layout, because every lane's randomness is keyed by its global
pixel id (ops/rng.py). Here a frame, a chunk of it or an adaptive pass's
list of tiles is one wavefront of lanes: rays for every lane, one bounce at
a time over the live lanes (pathtracer.run_bounces), then one ``frame_end``
that shades the misses and adds each lane's RGB into the (W, H, 3) buffer
at its pixel (with the per-pixel count and sum of squared luminance once
adaptive sampling is live). The preview keys its draws by pixel tile, so
its lanes follow the reference's tile-major order (render/raygen.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import constants as C

from ..assets.luts import CRFPack, SpectralLUTs, load_crf_pack, load_spectral_luts
from ..assets.textures import TextureAtlas, load_texture_atlas
from ..ops import rng
from . import adaptive
from . import film
from . import frame_end as fe
from . import pathtracer as pt
from . import raygen
from . import raymarcher
from .camera import CameraParams, HostCamera
from .params import SceneParams, TraceConfig, make_scene_params


def trace_lanes(base_key, spp: int, lane0: int, n: int, cam: CameraParams,
                scene: SceneParams, atlas: TextureAtlas, luts: SpectralLUTs,
                image_res, block, cfg: TraceConfig, color, count=None, lum2=None,
                mode: str = "path", interrupt=None, tile_ids=None, out_index=None,
                frame: raymarcher.PreviewFrame = None):
    """One sample for lanes [lane0, lane0 + n) of the frame's tile-major
    lane order over ``block`` (of the tiles ``tile_ids`` when given), added
    into ``color`` (W * H, 3) at pixel pu * H + pv, and into ``count`` /
    ``lum2`` (W * H,) when given (renderer.py:125-348 with the deposit of
    503-509; the preview branch is render_tile, 202-213). ``out_index`` (n,)
    int64 puts lane i at buffer row out_index[i] instead (a render mesh's
    device deposits into its own flat shard). The path tracer polls
    ``interrupt`` between bounces (pathtracer.run_bounces) and raises
    ``pathtracer.Interrupted`` before anything is deposited. ``frame`` is
    the preview kernel's parameter blocks (built here when None)."""
    preview = mode == "preview"
    rays = raygen.gen_rays(base_key, spp, lane0, n, image_res, block, cam, luts, preview,
                           tile_ids, cfg=cfg)
    dev = rays.dirs.device
    pid = rays.pid if out_index is None else out_index
    origin = cam.host.position
    if preview:
        # the spp key on the host: the preview kernel folds in each lane's tile
        spp_key = raygen.spp_key(base_key, spp)
        # on the card the kernel takes the shared origin by value
        pos = None if dev.type == "cuda" else _lane_origins(origin, dev, n)
        radiance = raymarcher.march_paths(
            spp_key, pos, rays.dirs, rays.wavelengths[:, 0], scene, atlas, luts, cfg,
            tile_index=rays.tile_index, lane=rays.lane_index, tile=block[0] * block[1],
            frame=frame, origin=origin,
        )
        fe.frame_end(rays.responses, pid, color, count, lum2, radiance=radiance[:, None],
                     pdf=rays.pdf)
        return
    st = pt.init_state(_lane_origins(origin, dev, n), rays.dirs, rays.wavelengths, rays.pdf,
                       rays.keys)
    st = pt.run_bounces(st, scene, atlas, luts, cfg, 0, cfg.max_bounces, interrupt)
    # miss lanes die at bounce 0 with their direction, throughput and w_mis
    # frozen, so shading them after the sweep is the reference's order
    # (renderer.py:328-331)
    fe.frame_end(rays.responses, pid, color, count, lum2,
                 miss=fe.MissShading(st, scene, atlas, luts, cfg))


def _lane_origins(origin, dev, n: int):
    """(n, 3) float32 copies of the host camera's ``origin``: one copy to the
    device that waits for nothing."""
    pos = torch.tensor(origin, dtype=torch.float32)
    return pos.to(dev, non_blocking=True).expand(n, 3).contiguous()


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
        self._scene_params = {}  # device -> (slider values, SceneParams)
        self._preview_frame = None  # (scene, atlas, luts, cfg, tile, PreviewFrame)

        self._seed_key = (0, int(seed) & rng.M32)  # jax.random.PRNGKey(seed)
        self.current_spp = 0
        self.total_samples = 0
        # the round of every lane key, shared by uniform and adaptive passes
        # (== current_spp while only accumulate() runs)
        self._rng_round = 0
        self._adaptive_rounds = 0
        self.color_buffer = torch.zeros(
            (image_res[0], image_res[1], 3), dtype=torch.float32, device=self.device
        )
        # adaptive sampling's per-pixel sample count and sum of squared
        # luminance, (W, H); None until the first accumulate_adaptive
        self.count_buffer = None
        self.lum2_buffer = None

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
    def host_camera(self) -> HostCamera:
        return HostCamera.of(self.camera_pos, self.look_at, self.up, self.fov, self.aspect_scale)

    def camera_params(self, device=None) -> CameraParams:
        """The camera as float32 tensors on ``device`` (the render device by
        default) with its host values; the frame's passes take it on the
        CPU, whose tensors cost the card no copy."""
        return self.host_camera().params(device or self.device)

    def scene_params(self, device=None) -> SceneParams:
        """The scene's tensors on ``device``, made again only when a slider
        has moved (a tensor made from host values waits for the card)."""
        device = torch.device(device or self.device)
        key = (self.sun_angle, self.sun_path_rot, self.land_height_scale)
        kept = self._scene_params.get(device)
        if kept is None or kept[0] != key:
            kept = (key, make_scene_params(device, *key))
            self._scene_params[device] = kept
        return kept[1]

    def _frame(self, scene: SceneParams):
        """The preview kernel's parameter blocks (None in path mode), made
        again only when the scene, atlas, tables, config or tile changed
        (they read no tensor). Kept on the CPU too, where the plain twin
        takes none, so that the cache behaves the same on either device."""
        if self.mode != "preview":
            return None
        key = (scene, self.atlas, self.luts, self.cfg, self.tile)
        kept = self._preview_frame
        if kept is None or any(a is not b for a, b in zip(kept[:5], key)):
            kept = (*key, raymarcher.PreviewFrame(*key))
            self._preview_frame = kept
        return kept[5]

    # --- main API -----------------------------------------------------------
    def reset_framebuffer(self):
        self.current_spp = 0
        self.total_samples = 0
        self._rng_round = 0
        self._adaptive_rounds = 0
        self.color_buffer.zero_()
        if self.count_buffer is not None:
            self.count_buffer.zero_()
            self.lum2_buffer.zero_()

    @property
    def mean_spp(self) -> float:
        """Average samples per pixel (== current_spp without adaptive passes)."""
        return self.total_samples / (self.image_res[0] * self.image_res[1])

    def accumulate(self):
        """Trace one sample per pixel into the accumulation buffer (through
        a uniform adaptive pass once per-pixel counts are live)."""
        if self.count_buffer is not None:
            self.accumulate_adaptive(frac=1.0)
        else:
            self.accumulate_interruptible(1)

    def accumulate_adaptive(self, frac: float = 0.25, min_warmup: int = 2,
                            interrupt=None) -> bool:
        """One adaptive pass (renderer.py:662): the ``k = max(1, int(n_tiles
        * frac))`` tiles with the highest estimated relative variance of their
        mean (render/adaptive.select_tiles) each get one more sample per
        pixel; the first ``min_warmup`` passes, and any with ``frac >= 1``,
        sample every pixel. Each pixel keeps its own count, and fetch_image
        divides by it. Keys are per (round, pixel), so a pixel's sample in a
        round does not depend on the selection: a uniform pass equals
        ``accumulate()`` bit for bit.

        The path tracer polls ``interrupt()`` between bounces; when it
        returns True the pass is dropped before anything is deposited (the
        buffers and the round stay as they were) and this returns False."""
        w, h = self.image_res
        if self.count_buffer is None:
            if self.current_spp:
                raise ValueError(
                    "adaptive accumulation must start from a reset framebuffer (per-pixel "
                    "counts for the earlier uniform passes were not tracked)"
                )
            self.count_buffer = torch.zeros((w, h), dtype=torch.float32, device=self.device)
            self.lum2_buffer = torch.zeros((w, h), dtype=torch.float32, device=self.device)
        bw, bh = self.block
        n_tiles = (w // bw) * (h // bh)
        uniform = self._adaptive_rounds < min_warmup or frac >= 1.0
        k = n_tiles if uniform else max(1, int(n_tiles * frac))
        if k >= n_tiles:
            # the whole frame: the path tracer's pixel order, as accumulate()
            k, tile_ids = n_tiles, None
            block = self.block if self.mode == "preview" else (1, h)
        else:
            tile_ids = adaptive.select_tiles(self.color_buffer, self.count_buffer,
                                             self.lum2_buffer, self.block, k)
            block = self.block
        scene = self.scene_params()
        try:
            trace_lanes(
                self._seed_key, self._rng_round, 0, k * self.tile, self.camera_params("cpu"),
                scene, self.atlas, self.luts, self.image_res, block, self.cfg,
                self.color_buffer.view(w * h, 3), self.count_buffer.view(-1),
                self.lum2_buffer.view(-1), mode=self.mode, interrupt=interrupt, tile_ids=tile_ids,
                frame=self._frame(scene),
            )
        except pt.Interrupted:
            return False
        self._rng_round += 1
        self._adaptive_rounds += 1
        self.total_samples += k * self.tile
        if uniform:
            self.current_spp += 1
        return True

    def accumulate_interruptible(self, n_chunks: int, interrupt=None) -> bool:
        """Trace one spp in ``n_chunks`` contiguous lane ranges (pixel ids
        in path mode), calling ``interrupt()`` between chunks once the device
        has finished the chunk, and in path mode between bounces too; abort,
        discarding the partial spp, when it returns True. Returns whether the
        spp completed (renderer.py:719; the reference polls between chunks
        only). Raises ``ValueError`` while per-pixel counts are live, as the
        reference does (use ``accumulate_adaptive`` or reset first).

        Every lane's randomness depends on its pixel (its tile in preview
        mode) and the round only, so the spp does not depend on the cut:
        bit-identical to ``accumulate()`` on the card."""
        if self.count_buffer is not None:
            raise ValueError(
                "interruptible accumulation does not track the adaptive per-pixel counts; "
                "use accumulate_adaptive or reset first"
            )
        w, h = self.image_res
        total = w * h
        per = -(-total // max(1, min(int(n_chunks), total)))
        block = self.block if self.mode == "preview" else (1, h)
        cam, scene = self.camera_params("cpu"), self.scene_params()
        # an abort raises before the chunk's deposit, so only a spp that can
        # be abandoned after a chunk has landed stages its chunks apart
        staged = interrupt is not None and per < total
        out = (torch.zeros((total, 3), dtype=torch.float32, device=self.device) if staged
               else self.color_buffer.view(total, 3))
        for lo in range(0, total, per):
            n = min(per, total - lo)
            try:
                trace_lanes(
                    self._seed_key, self._rng_round, lo, n, cam, scene, self.atlas,
                    self.luts, self.image_res, block, self.cfg, out, mode=self.mode,
                    interrupt=interrupt, frame=self._frame(scene),
                )
            except pt.Interrupted:
                return False
            if interrupt is not None and lo + n < total:
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()  # releases the GIL
                if interrupt():
                    return False
        if staged:
            self.color_buffer += out.view(w, h, 3)
        self.current_spp += 1
        self._rng_round += 1
        self.total_samples += total
        return True

    def fetch_image(self):
        """Post-processed (W, H, 3) float sRGB; each pixel divided by its own
        sample count once adaptive sampling is live."""
        spp = (self.count_buffer[..., None] if self.count_buffer is not None
               else float(self.current_spp))
        return film.postprocess(
            self.color_buffer, spp, self.exposure,
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
        """Write the resumable render state in the reference's file format,
        with the per-pixel counts when adaptive sampling is live."""
        extra = {}
        if self.count_buffer is not None:
            extra = dict(count_buffer=self.count_buffer.cpu().numpy(),
                         lum2_buffer=self.lum2_buffer.cpu().numpy())
        np.savez_compressed(
            path,
            color_buffer=self.color_buffer.cpu().numpy(),
            current_spp=self.current_spp,
            seed_key=np.asarray(self._seed_key, dtype=np.uint32),
            rng_round=self._rng_round,
            adaptive_rounds=self._adaptive_rounds,
            total_samples=self.total_samples,
            **extra,
        )

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint written by either renderer."""
        f32 = dict(dtype=torch.float32, device=self.device)
        with np.load(path) as z:
            buf = z["color_buffer"]
            if buf.shape != (*self.image_res, 3):
                raise ValueError(f"checkpoint buffer {buf.shape}, renderer {(*self.image_res, 3)}")
            self.color_buffer = torch.as_tensor(buf).to(**f32).contiguous()
            if "count_buffer" in z:
                self.count_buffer = torch.as_tensor(z["count_buffer"]).to(**f32).contiguous()
                self.lum2_buffer = torch.as_tensor(z["lum2_buffer"]).to(**f32).contiguous()
            else:
                self.count_buffer = self.lum2_buffer = None
            self.current_spp = int(z["current_spp"])
            self._seed_key = tuple(int(k) for k in z["seed_key"])
            # pre-adaptive checkpoints carry no round counters
            self._rng_round = int(z["rng_round"]) if "rng_round" in z else self.current_spp
            self._adaptive_rounds = int(z["adaptive_rounds"]) if "adaptive_rounds" in z else 0
            self.total_samples = (
                int(z["total_samples"]) if "total_samples" in z
                else self.current_spp * self.image_res[0] * self.image_res[1]
            )
