"""Progressive spectral renderer (port of digital_earth_tpu/render/renderer.py):
``set_*`` setters, ``accumulate()`` (one spp), ``fetch_image()`` /
``fetch_image_np()`` (the film chain), ``reset_framebuffer()``.

Schedule: the reference traces pixel blocks and compacts lane tiles
between bounce windows for the TPU; its output does not depend on that
layout, because every lane's randomness is keyed by its global pixel id
(ops/rng.py). Here the whole frame is one wavefront: rays for every pixel,
one bounce at a time over the live lanes (pathtracer.run_bounces), then
radiance lands in the (W, H, 3) buffer at the lane's pixel.
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
from .camera import CameraParams, cast_dirs
from .params import SceneParams, TraceConfig, make_scene_params

# Wavelengths per hero packet (reference TraceConfig.hero_lambdas).
HERO_LAMBDAS = 4
# Frame-level RNG site and the R3 rQMC constants (renderer.py:41-53).
_SITE_JITTER = 101
_PIXEL_DOMAIN = 0x70697865
_R3_G = 1.2207440846057596
_R3_A32 = tuple(
    int(round((1.0 / _R3_G**i % 1.0) * 2**32)) & 0xFFFFFFFF for i in (1, 2, 3)
)


def trace_frame(base_key, spp: int, cam: CameraParams, scene: SceneParams,
                atlas: TextureAtlas, luts: SpectralLUTs, image_res, cfg: TraceConfig):
    """One sample for every pixel: (W, H, 3) linear RGB (renderer.py:125-348
    with the ray generation of gen_rays, 160-194)."""
    w, h = image_res
    dev = base_key.device
    pid = torch.arange(w * h, dtype=torch.int64, device=dev)  # = pu * h + pv
    spp_key = rng.fold(base_key, spp)
    lkeys = rng.lane_keys(spp_key, pid)
    pu = (pid // h).to(torch.float32)
    pv = (pid % h).to(torch.float32)
    # randomized QMC primary dimensions (stratify_spp): per-pixel
    # Cranley-Patterson shift (spp-free key) + the R3 point of this spp
    pkeys = rng.lane_keys(rng.fold(base_key, _PIXEL_DOMAIN), pid)
    shift = rng.uniform(rng.fold(pkeys, _SITE_JITTER), (3,))
    seq = torch.tensor(
        [(a * (spp + 1)) & 0xFFFFFFFF for a in _R3_A32],
        dtype=torch.int64, device=dev,
    ).to(torch.float32) * 2.0**-32
    u3 = torch.remainder(shift + seq[:, None], 1.0)
    u_jit, u = u3[:2], u3[2]
    dirs = cast_dirs(cam, pu, pv, u_jit[0], u_jit[1], image_res)
    pos = cam.position.expand(w * h, 3).contiguous()

    wavelengths, responses, lambda_pdf = sp.spectrum_sample_hero(
        u, luts.cie_cdf, luts.cie_response, HERO_LAMBDAS
    )
    st = pt.init_state(pos, dirs, wavelengths, lambda_pdf, lkeys)
    st = pt.run_bounces(st, scene, atlas, luts, cfg, 0, 1)
    st = pt.shade_primary_miss(st, scene, atlas, luts, cfg)
    st = pt.run_bounces(st, scene, atlas, luts, cfg, 1, cfg.max_bounces)
    radiance = pt.finalize_radiance(st)
    xyz = mu.sum_last(radiance[:, None, :] * responses.transpose(1, 2))
    return sp.xyz_to_rgb(xyz).reshape(w, h, 3)


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
        seed: int = 0,
        cfg: TraceConfig = TraceConfig(),
        drt: str = "opendrt",
    ):
        self.device = torch.device(device)
        self.image_res = tuple(image_res)
        self.cfg = cfg
        self.drt = drt
        self.atlas = atlas if atlas is not None else load_texture_atlas(self.device)
        self.luts = luts if luts is not None else load_spectral_luts(self.device)
        self.crf = crf if crf is not None else load_crf_pack(self.device)
        self.crf_names = list(self.crf.names)

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

        self._base_key = rng.prng_key(seed, self.device)
        self.current_spp = 0
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
        self.color_buffer.zero_()

    def accumulate(self):
        """Trace one sample per pixel into the accumulation buffer."""
        self.color_buffer += trace_frame(
            self._base_key, self.current_spp, self.camera_params(),
            self.scene_params(), self.atlas, self.luts, self.image_res, self.cfg,
        )
        self.current_spp += 1

    def fetch_image(self):
        """Post-processed (W, H, 3) float sRGB."""
        return film.postprocess(
            self.color_buffer, float(self.current_spp), self.exposure,
            self.gamma, self.crf.curves, self.selected_crf, self.drt,
        )

    def fetch_image_np(self) -> np.ndarray:
        """(H, W, 3) uint8, row 0 at top."""
        img = self.fetch_image().cpu().numpy()
        img = np.transpose(img, (1, 0, 2))[::-1]
        return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
