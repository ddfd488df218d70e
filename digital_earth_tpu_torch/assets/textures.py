"""Scene texture atlas as uint8 (H, W, C) tensors (port of
digital_earth_tpu/assets/textures.py, with its semantics).

The numpy atlas builders (``build_max_mip``, ``build_cloud_mip``,
``build_atlas_arrays``, textures.py:115-253) are copied here because the
JAX module imports ``jax``; the procedural maps come from ``procgen``. NASA
files load per quality tier (``DE_TEXTURE_QUALITY``, tiers 0-2), each
missing map filled procedurally. A fully procedural large tier is the
device-upsampled atlas (``upsampled_procedural_atlas``): the cached
1350x2700 base planes upsampled on the card by the ``upsample`` kernel
(ops/texture.upsample), with the terrain-honesty jitter on topography and
clouds.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import texture
from .procgen import cached_earth_textures, default_cache_dir

# Quality tiers (reference lib/textures.py:1-8); tier 0 (4K) is the default.
TEXTURE_QUALITY = int(os.environ.get("DE_TEXTURE_QUALITY", "0"))
TEX_RES_4K = (3840, 1920)
TEX_RES_8K = (8100, 4050)
TEX_RES_10K = (10800, 5400)
TEX_RES_16K = (16200, 8100)
TEX_RES_21K = (21600, 10800)

_TIER_FILES = {
    0: dict(
        albedo="earth_color_4K.png",
        topography="topography_4K.png",
        ocean="earth_landocean_4K.png",
        clouds="earth_clouds_4K.png",
        bathymetry="earth_bathymetry_4k.png",
        emissive="earth_nightlights_4K.png",
        stars="stars_8K.jpg",
    ),
    1: dict(
        albedo="earth_color_10K.png",
        topography="topography_10K.png",
        ocean="earth_landocean_8K.png",
        clouds="earth_clouds_8K.png",
        bathymetry="earth_bathymetry_10k.png",
        emissive="earth_nightlights_10K.png",
        stars="stars_16K.png",
    ),
    2: dict(
        albedo="earth_color_21K.png",
        topography="topography_21K.png",
        ocean="earth_landocean_16K.png",
        clouds="earth_clouds_21K.png",
        bathymetry="earth_bathymetry_21k.png",
        emissive="earth_nightlights_21K.png",
        stars="stars_16K.png",
    ),
}


class TextureAtlas(NamedTuple):
    """material (H, W, 8): [albedo rgb, ocean, bathymetry, emissive,
    topography, clouds]; topography (H, W, 4): [height, wide 25 km max-mip,
    coarse 115 km max-mip, tight 8 km max-mip]; clouds (H, W, 4): [column
    height, tight 8 km mip, coarse mip, wide 25 km mip]; stars (H, W, 3).
    All uint8."""

    material: torch.Tensor
    topography: torch.Tensor
    clouds: torch.Tensor
    stars: torch.Tensor


MIP_FINE_H = 4096
MIP_COARSE_H = 128
MIP_FINE_VALID_KM = 25.0
MIP_CLOUD_FINE_VALID_KM = 8.0
MIP_COARSE_VALID_KM = 115.0


def build_max_mip(
    img: np.ndarray,
    dilate_km: float = None,
    mip_h: int = MIP_COARSE_H,
    mip_w: int = 2 * MIP_COARSE_H,
    shell_r: float = 6371e3 + 10e3,
    valid_km: float = None,
) -> np.ndarray:
    """Coarse (mip_h, mip_w) max-pool of a scalar map, dilated so the cell
    containing any point bounds the map within ``dilate_km`` of it
    (latitude-aware in longitude, wrapping); ``valid_km`` derives the
    dilation from the cell size."""
    h, w = img.shape[:2]
    mip_h = min(mip_h, h)
    mip_w = min(mip_w, w)
    if dilate_km is None:
        cell_h_km = np.pi * shell_r / mip_h / 1e3
        cell_w_km = 2 * np.pi * shell_r / mip_w / 1e3
        dilate_km = valid_km + 1.05 * max(cell_h_km, cell_w_km)
    c = img if img.ndim == 2 else img[..., 0]
    c = c.astype(np.float32) / (255.0 if img.dtype == np.uint8 else 1.0)
    ph = -h % mip_h
    pw = -w % mip_w
    cp = np.pad(c, ((0, ph), (0, pw)), mode="edge")
    bh, bw = cp.shape[0] // mip_h, cp.shape[1] // mip_w
    coarse = cp.reshape(mip_h, bh, mip_w, bw).max(axis=(1, 3))

    cell_h_km = np.pi * shell_r / mip_h / 1e3
    dil_v = int(np.ceil(dilate_km / cell_h_km))
    out = coarse.copy()
    for dv in range(-dil_v, dil_v + 1):
        shifted = coarse[np.clip(np.arange(mip_h) + dv, 0, mip_h - 1)]
        out = np.maximum(out, shifted)
    lat = (0.5 - (np.arange(mip_h) + 0.5) / mip_h) * np.pi
    cell_w_km = 2 * np.pi * shell_r * np.maximum(np.cos(lat), 1e-3) / mip_w / 1e3
    dilated = out.copy()
    for row in range(mip_h):
        du = int(np.ceil(dilate_km / cell_w_km[row]))
        if du >= mip_w // 2:
            dilated[row, :] = out[row].max()
            continue
        for d in range(1, du + 1):
            dilated[row] = np.maximum(dilated[row], np.roll(out[row], d))
            dilated[row] = np.maximum(dilated[row], np.roll(out[row], -d))
    return dilated


def build_cloud_mip(clouds: np.ndarray) -> np.ndarray:
    return build_max_mip(clouds, valid_km=MIP_COARSE_VALID_KM)


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if img.shape[:2] == (h, w):
        return img
    ys = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    xs = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[ys][:, xs]


def build_atlas_arrays(arrays: dict) -> dict:
    """Image-space packed uint8 planes of the atlas: ``material`` (H, W, 8),
    ``topography`` (H, W, 4), ``clouds`` (H, W, 4), ``stars`` (H, W, 3)."""
    albedo = arrays["albedo"]
    h, w = albedo.shape[:2]
    mat = np.concatenate(
        [
            albedo[..., :3],
            _resize_nearest(arrays["ocean"], h, w)[..., None],
            _resize_nearest(arrays["bathymetry"], h, w)[..., None],
            _resize_nearest(arrays["emissive"], h, w)[..., None],
            _resize_nearest(arrays["topography"], h, w)[..., None],
            _resize_nearest(arrays["clouds"], h, w)[..., None],
        ],
        axis=-1,
    )

    def with_mips(img, fine_valid_km, extra_valid_km):
        """(H, W, 4) uint8: [map, fine max-mip, coarse max-mip, extra
        max-mip], each mip upsampled to full resolution and ceil-quantized
        so it stays a conservative upper bound."""
        if img.ndim == 3:
            img = img[..., 0]
        ih, iw = img.shape

        def mip_channel(mip_h, valid_km):
            mip = build_max_mip(
                img, mip_h=mip_h, mip_w=2 * mip_h, valid_km=valid_km
            )
            return _resize_nearest(
                (mip * 255.0 + 0.999).clip(0, 255).astype(np.uint8), ih, iw
            )

        fine = mip_channel(MIP_FINE_H, fine_valid_km)
        coarse = mip_channel(MIP_COARSE_H, MIP_COARSE_VALID_KM)
        extra = mip_channel(MIP_FINE_H, extra_valid_km)
        return np.stack([img, fine, coarse, extra], axis=-1)

    return {
        "material": mat,
        "topography": with_mips(
            arrays["topography"], MIP_FINE_VALID_KM, MIP_CLOUD_FINE_VALID_KM
        ),
        "clouds": with_mips(
            arrays["clouds"], MIP_CLOUD_FINE_VALID_KM, MIP_FINE_VALID_KM
        ),
        "stars": np.ascontiguousarray(arrays["stars"][..., :3]),
    }


# Terrain-honesty jitter of the device-upsampled tiers (JAX
# assets/textures.py:243-250): each upsampled topography and cloud texel is
# scaled by (1 - u * jitter), u a per-texel hash, downward only, so the
# max-mips built from the base stay conservative.
UPSAMPLE_JITTER = float(os.environ.get("DE_UPSAMPLE_JITTER", "0.06"))


def pack_atlas(planes: dict, device, upsample: int = 1, jitter: float = None) -> TextureAtlas:
    """Image-space uint8 planes -> TextureAtlas on ``device``, each plane
    nearest-neighbour-upsampled there by the integer ``upsample`` when it
    is above 1 (ops/texture.upsample), the topography and cloud maps with
    the per-texel jitter (``UPSAMPLE_JITTER``; channel 0 only, so the mip
    channels stay exact)."""
    if jitter is None:
        jitter = UPSAMPLE_JITTER

    def plane(name, **kw):
        t = torch.from_numpy(np.ascontiguousarray(planes[name])).to(device)
        return texture.upsample(t, upsample, **kw) if upsample > 1 else t

    return TextureAtlas(
        material=plane("material"),
        topography=plane("topography", jitter=jitter, jitter_seed=0x7071),
        clouds=plane("clouds", jitter=jitter, jitter_seed=0xC10D),
        stars=plane("stars"),
    )


def build_atlas(arrays: dict, device) -> TextureAtlas:
    """Raw (H, W[, C]) uint8 maps -> TextureAtlas on ``device``."""
    return pack_atlas(build_atlas_arrays(arrays), device)


# Bump when the packed-plane layout or the mip parameters above change: the
# packed-atlas disk cache (cached_atlas_arrays) keys on it.
ATLAS_PACK_VERSION = "r4a"


def cached_atlas_arrays(resolution, seed: int = 7, cache_dir=None) -> dict:
    """Build-or-load the packed procedural atlas planes for ``resolution``,
    each plane cached as its own .npy (written through a .tmp file and
    ``os.replace``) as soon as it is built."""
    h, w = resolution
    cache_dir = default_cache_dir() if cache_dir is None else cache_dir
    os.makedirs(cache_dir, exist_ok=True)
    stem = os.path.join(cache_dir, f"atlas_{ATLAS_PACK_VERSION}_{h}x{w}_s{seed}")
    paths = {n: f"{stem}_{n}.npy" for n in TextureAtlas._fields}
    if all(os.path.exists(p) for p in paths.values()):
        return {n: np.load(p) for n, p in paths.items()}
    packs = build_atlas_arrays(cached_earth_textures(resolution, seed, cache_dir))
    for n, p in paths.items():
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:  # np.save(path) would append ".npy"
            np.save(f, packs[n])
        os.replace(tmp, p)
    return packs


def upsampled_procedural_atlas(device, target_resolution, base_resolution=(1350, 2700),
                               seed: int = 7, cache_dir=None,
                               jitter: float = None) -> TextureAtlas:
    """Tier-2-scale procedural atlas: the cached base planes upsampled on
    ``device`` by an integer factor. It has the memory footprint and the
    gather cost of a real ``target_resolution`` texture set; its content is
    the base set block-repeated (plus the jitter), and the base's max-mips
    bound the repeat exactly."""
    th, tw = target_resolution
    bh, bw = base_resolution
    if th % bh or tw % bw or th // bh != tw // bw:
        raise ValueError(
            f"target {target_resolution} must be an integer multiple of "
            f"base {base_resolution}"
        )
    packs = cached_atlas_arrays(base_resolution, seed, cache_dir)
    return pack_atlas(packs, device, upsample=th // bh, jitter=jitter)


_SINGLE_CHANNEL = ("topography", "ocean", "clouds", "bathymetry", "emissive")


def _load_image(path: str, single_channel: bool) -> np.ndarray:
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # the 21600x10800 tier exceeds PIL's default cap
    img = np.asarray(Image.open(path))
    if single_channel:
        if img.ndim == 3:
            img = img[..., 0]
    else:
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        img = img[..., :3]
    return img.astype(np.uint8)


def load_texture_atlas(
    device,
    texture_dir: str = "textures",
    quality: Optional[int] = None,
    procedural_resolution=(1024, 2048),
    procedural_seed: int = 7,
) -> TextureAtlas:
    """The tier's NASA files under ``texture_dir`` (``quality``, default
    ``TEXTURE_QUALITY``), each missing map filled procedurally. With every
    file missing, a large ``procedural_resolution`` (a multiple of 1350 rows
    from 4050, 2:1) is the device-upsampled atlas, a small one the procedural
    set built at that resolution."""
    quality = TEXTURE_QUALITY if quality is None else quality
    files = _TIER_FILES[quality]
    arrays = {}
    missing = []
    for name, fn in files.items():
        path = os.path.join(texture_dir, fn)
        if os.path.exists(path):
            arrays[name] = _load_image(path, name in _SINGLE_CHANNEL)
        else:
            missing.append(name)
    if len(missing) == len(files):
        h, w = procedural_resolution
        if h >= 4050 and h % 1350 == 0 and w == 2 * h:
            return upsampled_procedural_atlas(
                device, procedural_resolution, (1350, 2700), procedural_seed
            )
        return build_atlas(cached_earth_textures(procedural_resolution, procedural_seed), device)
    if missing:
        proc = cached_earth_textures(procedural_resolution, procedural_seed)
        for name in missing:
            arrays[name] = proc[name]
    return build_atlas(arrays, device)


def procedural_texture_atlas(device, resolution=(1024, 2048), seed: int = 7,
                             cache_dir=None) -> TextureAtlas:
    """The deterministic procedural set of ``procgen.generate_earth_textures``,
    through the disk cache (``cached_earth_textures``)."""
    return build_atlas(cached_earth_textures(resolution, seed, cache_dir), device)
