"""The port's texture path against the JAX package's, on the CPU: the
upsample of the tier-2 atlas (``ops/texture.upsample_plain`` against
``Tex2D.from_upsampled``), the cached and upsampled procedural atlases, and
the tiered file loader. Both sides hold uint8 texels, so every comparison
is bit for bit, except the render at the end, which states its share.

Tests that would reach the default disk cache point ``HOME`` at a
temporary directory first, so neither package's real cache is read or
written.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.assets import textures as jtex
from digital_earth_tpu.ops.texture import Tex2D
from digital_earth_tpu_torch import convert
from digital_earth_tpu_torch.assets import procgen as tproc
from digital_earth_tpu_torch.assets import textures as ttex
from digital_earth_tpu_torch.ops import texture as ttx

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


def _jax_image(tex):
    return convert.tex2d_array(tex.rows, tex.h, tex.w, tex.channels)


def _assert_atlas_equal(tatlas, jatlas):
    for name in ttex.TextureAtlas._fields:
        got = getattr(tatlas, name)
        want = convert.tex2d_to_tensor(getattr(jatlas, name), "cpu")
        assert got.dtype == torch.uint8 and got.shape == want.shape, name
        assert torch.equal(got, want), name


# (shape, factor, jitter, seed): the five cases of tests/test_texture.py
# TestUpsampledAtlas, then jittered ones with each channel count and seed
# of the atlas (0x7071 topography, 0xC10D clouds)
UPSAMPLE_CASES = [
    ((6, 12, 8), 4, 0.0, 0), ((5, 10, 4), 3, 0.0, 0), ((7, 14, 3), 6, 0.0, 0),
    ((4, 8), 2, 0.0, 0), ((6, 12, 8), 1, 0.0, 0),
    ((6, 12, 8), 4, 0.06, 0x7071), ((6, 12, 8), 3, 0.06, 0xC10D),
    ((5, 10, 4), 3, 0.06, 0x7071), ((9, 18, 4), 8, 0.06, 0xC10D),
    ((7, 14, 3), 6, 0.06, 0x7071), ((7, 14, 3), 5, 0.06, 0xC10D),
]


@pytest.mark.parametrize("shape,factor,jitter,seed", UPSAMPLE_CASES)
def test_upsample_matches_jax(shape, factor, jitter, seed):
    rng = np.random.default_rng(sum(shape) * 31 + factor)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[:2, :3] = 0  # an exact-zero (ocean) patch
    ref = Tex2D.from_upsampled(jnp.asarray(img), factor, jitter=jitter, jitter_seed=seed)
    want = _jax_image(ref)
    got = ttx.upsample(torch.from_numpy(img), factor, jitter, jitter_seed=seed)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if jitter == 0.0:  # the plain repeat of tests/test_texture.py
        rep = np.repeat(np.repeat(img.reshape(want.shape[0] // factor, -1, want.shape[2]),
                                  factor, 0), factor, 1)
        np.testing.assert_array_equal(got.numpy(), rep)


def test_upsample_jitter_properties():
    """tests/test_texture.py:317-340 on the port's (H, W, C) layout:
    deterministic, channel 0 only, downward only and within 6% (plus the
    rounding), zero stays zero, and over 30% of texels move."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (6, 12, 4), dtype=np.uint8)
    img[:2, :3, 0] = 0
    t = torch.from_numpy(img)
    ref = ttx.upsample_plain(t, 4).numpy().astype(int)
    a = ttx.upsample_plain(t, 4, jitter=0.06).numpy().astype(int)
    b = ttx.upsample_plain(t, 4, jitter=0.06).numpy().astype(int)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[..., 1:], ref[..., 1:])
    assert (a[..., 0] <= ref[..., 0]).all()
    assert (a[..., 0] >= np.floor(ref[..., 0] * 0.94) - 1).all()
    assert (a[..., 0][ref[..., 0] == 0] == 0).all()
    assert (a[..., 0] != ref[..., 0]).mean() > 0.3
    # another channel and seed move other texels of that channel only
    c = ttx.upsample_plain(t, 4, jitter=0.06, jitter_channel=2, jitter_seed=0xC10D).numpy()
    np.testing.assert_array_equal(c[..., [0, 1, 3]], ref[..., [0, 1, 3]])
    assert (c[..., 2] != ref[..., 2]).mean() > 0.3


def test_mul32_hash_matches_uint32_arithmetic():
    """The twin's int64 hash equals uint32 arithmetic, across the whole
    32-bit range of texel ids."""
    ids = np.concatenate([np.arange(4096, dtype=np.uint64),
                          np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64),
                          np.array([2**32 - 1], dtype=np.uint64)])
    x = ids.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
    got = ttx._lowbias32(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, x.astype(np.int64))


def test_cached_earth_textures_lookup_order(tmp_path, home):
    """The cache directory first, then the shipped base, else generate and
    save; the default directory is the port's own."""
    assert tproc.default_cache_dir() == os.path.join(str(home), ".cache",
                                                     "digital_earth_tpu_torch")
    from digital_earth_tpu.assets.procgen import cached_earth_textures

    cache = tmp_path / "c"
    small = tproc.cached_earth_textures((16, 32), 3, cache_dir=str(cache))
    assert (cache / "procgen_16x32_s3.npz").exists()
    want = cached_earth_textures((16, 32), 3, cache_dir=str(tmp_path / "j"))
    for k in want:
        np.testing.assert_array_equal(small[k], want[k])
    # a cached file wins over generation
    fake = {k: np.zeros_like(v) for k, v in small.items()}
    np.savez_compressed(cache / "procgen_16x32_s3.npz", **fake)
    again = tproc.cached_earth_textures((16, 32), 3, cache_dir=str(cache))
    assert all(not again[k].any() for k in again)
    # the shipped 1350x2700 base is read without writing the cache
    base = tproc.cached_earth_textures((1350, 2700), 7, cache_dir=str(cache))
    assert base["topography"].shape == (1350, 2700)
    assert not (cache / "procgen_1350x2700_s7.npz").exists()
    assert not os.path.exists(tproc.default_cache_dir())


def test_cached_atlas_arrays_round_trip(tmp_path):
    base = (16, 32)
    packs = ttex.cached_atlas_arrays(base, seed=3, cache_dir=str(tmp_path))
    names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npy"))
    assert names == sorted(f"atlas_{ttex.ATLAS_PACK_VERSION}_16x32_s3_{n}.npy"
                           for n in ttex.TextureAtlas._fields)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    packs2 = ttex.cached_atlas_arrays(base, seed=3, cache_dir=str(tmp_path))
    want = jtex.cached_atlas_arrays(base, seed=3, cache_dir=str(tmp_path / "jax"))
    for k in ttex.TextureAtlas._fields:
        np.testing.assert_array_equal(packs[k], packs2[k])
        np.testing.assert_array_equal(packs[k], want[k])


@pytest.mark.parametrize("jitter", [0.0, 0.06])
def test_upsampled_procedural_atlas_matches_jax(tmp_path, jitter):
    got = ttex.upsampled_procedural_atlas("cpu", (48, 96), (16, 32), seed=3,
                                          cache_dir=str(tmp_path / "t"), jitter=jitter)
    want = jtex.upsampled_procedural_atlas((48, 96), (16, 32), seed=3,
                                           cache_dir=str(tmp_path / "j"), jitter=jitter)
    _assert_atlas_equal(got, want)
    assert got.topography.shape == (48, 96, 4) and got.material.shape == (48, 96, 8)


def test_upsample_jitter_default_is_the_jax_packages():
    assert ttex.UPSAMPLE_JITTER == jtex.UPSAMPLE_JITTER
    assert ttex.ATLAS_PACK_VERSION == jtex.ATLAS_PACK_VERSION


@pytest.mark.parametrize("target", [(50, 100), (48, 64), (40, 80)])
def test_non_integer_factor_rejected(tmp_path, target):
    with pytest.raises(ValueError):
        ttex.upsampled_procedural_atlas("cpu", target, (16, 32), cache_dir=str(tmp_path))


def _write_tier(tmp_path, quality, h=16, w=32, skip=()):
    from PIL import Image

    rng = np.random.default_rng(11 + quality)
    for name, fn in ttex._TIER_FILES[quality].items():
        if name in skip:
            continue
        shape = (h, w, 3) if name in ("albedo", "stars") else (h, w)
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(tmp_path / fn)


def test_tier_files_are_the_jax_packages():
    assert ttex._TIER_FILES == jtex._TIER_FILES
    assert ttex.TEX_RES_21K == jtex.TEX_RES_21K and ttex.TEX_RES_4K == jtex.TEX_RES_4K
    assert ttex.TEXTURE_QUALITY == jtex.TEXTURE_QUALITY


@pytest.mark.parametrize("quality", [0, 1, 2])
def test_atlas_from_tier_files_matches_jax(tmp_path, home, quality):
    """Small PNG/JPG files written under the tier's names load into the
    same atlas in both packages (tests/test_texture.py:180-212)."""
    tex_dir = tmp_path / "tex"
    tex_dir.mkdir()
    _write_tier(tex_dir, quality)
    got = ttex.load_texture_atlas("cpu", texture_dir=str(tex_dir), quality=quality)
    _assert_atlas_equal(got, jtex.load_texture_atlas(texture_dir=str(tex_dir), quality=quality))


@pytest.mark.parametrize("quality,skip", [(0, ("clouds", "stars")), (2, ("topography",)),
                                          (1, ("albedo", "emissive", "bathymetry"))])
def test_partial_download_fallback_matches_jax(tmp_path, home, quality, skip):
    """Each missing file is filled from the procedural set
    (tests/test_texture.py:214-237)."""
    tex_dir = tmp_path / "tex"
    tex_dir.mkdir()
    _write_tier(tex_dir, quality, skip=skip)
    kw = dict(texture_dir=str(tex_dir), quality=quality, procedural_resolution=(16, 32))
    got = ttex.load_texture_atlas("cpu", **kw)
    _assert_atlas_equal(got, jtex.load_texture_atlas(**kw))
    proc = tproc.cached_earth_textures((16, 32), 7)
    if "clouds" in skip:
        np.testing.assert_array_equal(got.clouds[..., 0].numpy(), proc["clouds"])
    if "topography" in skip:
        np.testing.assert_array_equal(got.topography[..., 0].numpy(), proc["topography"])


def test_fully_procedural_small_tier_matches_jax(tmp_path, home):
    kw = dict(texture_dir=str(tmp_path / "none"), quality=0, procedural_resolution=(32, 64),
              procedural_seed=3)
    _assert_atlas_equal(ttex.load_texture_atlas("cpu", **kw), jtex.load_texture_atlas(**kw))
    assert (home / ".cache" / "digital_earth_tpu_torch" / "procgen_32x64_s3.npz").exists()


@pytest.mark.parametrize("resolution,upsampled", [
    ((10800, 21600), True), ((4050, 8100), True), ((5400, 10800), True),
    ((4096, 8192), False), ((1024, 2048), False),
])
def test_large_procedural_tier_routes_to_upsampled_atlas(tmp_path, home, monkeypatch,
                                                         resolution, upsampled):
    """With every file missing, a large tier goes to the device-upsampled
    atlas of the 1350x2700 base (as JAX routes it, assets/textures.py:387-396),
    a small one to the procedural set at its resolution. The calls are
    recorded, so the CPU never builds the full-size atlas."""
    calls = []
    monkeypatch.setattr(ttex, "upsampled_procedural_atlas",
                        lambda *a, **k: calls.append(("up", a, k)) or "upsampled")
    monkeypatch.setattr(ttex, "cached_earth_textures",
                        lambda *a, **k: calls.append(("proc", a, k)) or {})
    monkeypatch.setattr(ttex, "build_atlas", lambda arrays, device: "built")
    got = ttex.load_texture_atlas("cpu", texture_dir=str(tmp_path / "none"), quality=2,
                                  procedural_resolution=resolution)
    if upsampled:
        assert got == "upsampled"
        assert calls == [("up", ("cpu", resolution, (1350, 2700), 7), {})]
    else:
        assert got == "built"
        assert calls == [("proc", (resolution, 7), {})]


def test_default_quality_is_texture_quality(tmp_path, home, monkeypatch):
    """``quality=None`` reads the tier of DE_TEXTURE_QUALITY
    (``TEXTURE_QUALITY``), as the Renderer's default atlas does."""
    tex_dir = tmp_path / "tex"
    tex_dir.mkdir()
    _write_tier(tex_dir, 2)
    read = []
    load = ttex._load_image
    monkeypatch.setattr(ttex, "_load_image", lambda path, single: read.append(path) or
                        load(path, single))
    monkeypatch.setattr(ttex, "TEXTURE_QUALITY", 2)
    got = ttex.load_texture_atlas("cpu", texture_dir=str(tex_dir))
    assert sorted(os.path.basename(p) for p in read) == sorted(ttex._TIER_FILES[2].values())
    _assert_atlas_equal(got, jtex.load_texture_atlas(texture_dir=str(tex_dir), quality=2))


def test_render_on_upsampled_atlas_matches_jax(tmp_path):
    """Apollo 11 at 48x27, 1 spp, default TraceConfig(), on a 2x upsampled
    64x128 base with the 0.06 jitter: the port's Renderer against the JAX
    Renderer on the same atlas. Measured: 0.9591 of pixels within rtol 1e-3
    (the rounding spread of test_torch_render.py's default-config test, 0.96
    on Apollo), channel means within 0.3%; stated floor 0.95, means within
    5%."""
    from digital_earth_tpu.app.config_io import apply_config, load_config
    from digital_earth_tpu.render.renderer import Renderer as JaxRenderer
    from digital_earth_tpu_torch.app.viewer import render_offline

    jatlas = jtex.upsampled_procedural_atlas((128, 256), (64, 128), seed=3,
                                             cache_dir=str(tmp_path / "j"), jitter=0.06)
    tatlas = ttex.upsampled_procedural_atlas("cpu", (128, 256), (64, 128), seed=3,
                                             cache_dir=str(tmp_path / "t"), jitter=0.06)
    _assert_atlas_equal(tatlas, jatlas)
    cfg = load_config(os.path.join(ROOT, "scenes", "config - Apollo 11.txt"))
    ref = JaxRenderer(image_res=(48, 27), atlas=jatlas, tile_pixels=1296)
    apply_config(ref, cfg)
    ref.accumulate()
    want = np.asarray(ref.color_buffer)
    got = render_offline(cfg, "cpu", spp=1, image_res=(48, 27), out_path=None,
                         atlas=tatlas).color_buffer.numpy()
    assert np.isfinite(got).all() and got.mean() > 0.0
    share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= 0.95, share
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.05)
