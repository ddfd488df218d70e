"""Procedural Earth-like texture synthesis (numpy; a copy of
digital_earth_tpu/assets/procgen.py without its disk cache, so the port
imports nothing of the JAX package; tests/test_torch_elementwise.py holds
the two outputs equal).

The reference renders NASA equirect imagery downloaded out-of-band
(reference README.md:28-29, lib/textures.py:10-46); when those files are not
present we synthesize a deterministic Earth-like texture set with the same
channels and orientation so the full pipeline (albedo grading, topography
displacement, ocean mask, cloud coverage, bathymetry, nightlights, stars)
runs end-to-end and can be benchmarked.

All maps are (H, W[, C]) uint8, row 0 = north pole, u wraps in longitude.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _upsample_wrap(grid, h, w):
    """Bilinear upsample a coarse (gh, gw) grid to (h, w), wrapping in x."""
    gh, gw = grid.shape
    y = np.linspace(0.0, gh - 1.0, h, dtype=grid.dtype)
    x = np.linspace(0.0, gw, w, endpoint=False, dtype=grid.dtype)
    y0 = np.floor(y).astype(int)
    y1 = np.minimum(y0 + 1, gh - 1)
    ty = (y - y0)[:, None]
    x0 = np.floor(x).astype(int) % gw
    x1 = (x0 + 1) % gw
    tx = (x - np.floor(x))[None, :]
    top = grid[y0][:, x0] * (1 - tx) + grid[y0][:, x1] * tx
    bot = grid[y1][:, x0] * (1 - tx) + grid[y1][:, x1] * tx
    return top * (1 - ty) + bot * ty


def fbm(rng, h, w, octaves=6, base=4, gain=0.5, lacunarity=2.0):
    """Fractal value noise in [0, 1]-ish (zero-mean sum, renormalized)."""
    # f32 for large tiers only: at 21600x10800 the f64 temporaries make
    # generation memory-bound (1.9 GB per full-res array); small (golden-
    # covered) resolutions keep f64 so cached/golden outputs stay stable.
    dtype = np.float32 if h * w >= 8100 * 4050 else np.float64
    total = np.zeros((h, w), dtype=dtype)
    amp = 1.0
    freq = base
    norm = 0.0
    for _ in range(octaves):
        gh = max(2, int(freq))
        gw = max(4, int(freq * 2))
        grid = rng.standard_normal((gh, gw)).astype(dtype)
        total += amp * _upsample_wrap(grid, h, w)
        norm += amp
        amp *= gain
        freq *= lacunarity
    total /= norm
    lo, hi = np.percentile(total, [1, 99])
    return np.clip((total - lo) / max(hi - lo, 1e-6), 0.0, 1.0)


def _smoothstep(e0, e1, x):
    t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3 - 2 * t)


def generate_earth_textures(resolution=(1024, 2048), seed=7) -> Dict[str, np.ndarray]:
    """Synthesize the full texture set. Returns dict of uint8 arrays."""
    h, w = resolution
    rng = np.random.default_rng(seed)

    continents = fbm(rng, h, w, octaves=5, base=3)
    relief = fbm(rng, h, w, octaves=8, base=6)
    vegetation = fbm(rng, h, w, octaves=5, base=5)
    cloud_field = fbm(rng, h, w, octaves=6, base=4)
    city_field = fbm(rng, h, w, octaves=7, base=24, gain=0.65)

    lat = np.linspace(np.pi / 2, -np.pi / 2, h)[:, None]  # row 0 = north
    polar = _smoothstep(0.72, 0.9, np.abs(lat) / (np.pi / 2)) * np.ones((1, w))

    # ~35% land
    sea_level = np.quantile(continents, 0.65)
    landness = _smoothstep(sea_level - 0.015, sea_level + 0.015, continents)
    ocean = 1.0 - landness

    # Topography: coastal shelf + mountain ridges; normalized so 1.0 maps to
    # the renderer's land_height_scale displacement.
    elevation = np.clip(continents - sea_level, 0.0, None)
    elevation = elevation / max(elevation.max(), 1e-6)
    mountains = np.clip(relief - 0.55, 0, None) ** 1.5 * 2.2
    topography = np.clip((elevation * (0.35 + mountains)) * landness, 0.0, 1.0)

    # Albedo (sRGB-ish satellite look)
    desert = np.stack(
        [0.45 + 0.1 * relief, 0.35 + 0.06 * relief, 0.22 + 0.03 * relief], axis=-1
    )
    forest = np.stack(
        [0.06 + 0.05 * relief, 0.16 + 0.08 * vegetation, 0.04 + 0.04 * relief], axis=-1
    )
    dry = _smoothstep(0.35, 0.75, 1.0 - vegetation) * (
        1.0 - _smoothstep(0.3, 0.75, np.abs(lat) / (np.pi / 2)) * np.ones((1, w))
    )
    land_albedo = forest * (1 - dry[..., None]) + desert * dry[..., None]
    snow = np.maximum(polar, _smoothstep(0.75, 0.9, topography))[..., None]
    land_albedo = land_albedo * (1 - snow) + snow * 0.85

    depth = np.clip(sea_level - continents, 0.0, None)
    depth = depth / max(depth.max(), 1e-6)
    ocean_albedo = np.stack(
        [
            0.05 + 0.02 * (1 - depth),
            0.08 + 0.05 * (1 - depth),
            0.16 + 0.10 * (1 - depth),
        ],
        axis=-1,
    )
    albedo = land_albedo * landness[..., None] + ocean_albedo * ocean[..., None]

    # Clouds: broken coverage with large clear patches
    clouds = _smoothstep(0.55, 0.8, cloud_field) * (0.4 + 0.6 * relief)

    # Bathymetry texture drives ocean roughness variation
    bathymetry = np.clip(depth * ocean + landness * 0.0, 0.0, 1.0)

    # Nightlights: sparse city clusters on low-altitude, non-polar land
    cities = np.clip(city_field - 0.72, 0, None) / 0.28
    emissive = np.clip(
        cities**2.2 * landness * (1 - polar) * (1 - _smoothstep(0.3, 0.6, topography)),
        0,
        1,
    )

    # Stars: sparse bright points + a faint galactic band
    stars = np.zeros((h, w))
    n_stars = (h * w) // 600
    ys = rng.integers(0, h, n_stars)
    xs = rng.integers(0, w, n_stars)
    stars[ys, xs] = rng.random(n_stars) ** 3
    band = np.exp(-0.5 * ((np.linspace(-1, 1, h)[:, None] * np.ones((1, w))) / 0.25) ** 2)
    stars = np.clip(stars + 0.02 * band * fbm(rng, h, w, octaves=4, base=8), 0, 1)
    stars_rgb = np.stack([stars, stars * 0.98, stars * 0.95], axis=-1)

    to_u8 = lambda a: (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return {
        "albedo": to_u8(albedo),
        "topography": to_u8(topography),
        "ocean": to_u8(ocean),
        "clouds": to_u8(clouds),
        "bathymetry": to_u8(bathymetry),
        "emissive": to_u8(emissive),
        "stars": to_u8(stars_rgb),
    }
