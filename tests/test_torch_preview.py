"""The preview path of the PyTorch port against the JAX package on the CPU,
on the same numpy-seeded inputs:

- ``rng.split`` / ``uniform_key`` bit-equal to ``jax.random``;
- ``spectrum_sample`` (the preview's single wavelength) and ``earth_brdf``;
- ``pick_block_dims`` and the tile-major lane map equal to the reference's
  ``_pick_block_dims`` / ``_tile_pixel_coords``;
- the two atmosphere-march twins (``_ray_march_transmittance``,
  ``_ray_march_atmos``) on 4096 lanes, and ``march_paths_plain`` (the
  ``preview`` kernel's twin) on 2048 lanes of one tile key, against the
  reference functions; ``march_paths`` on CPU tensors is that twin, bit for
  bit; ``PreviewFrame``'s parameter blocks hold the twin's own float32
  scalars; the kernel's key recipe, as a plain per-lane function, draws
  ``_bounce_draws``'s numbers bit for bit;
- the preview renderer against the committed 32x18 golden (one tile) and
  against the live JAX preview renderer at 64x36 with 192-pixel (16x12)
  tiles (12 tiles, so the per-tile keys are exercised);
- ``postprocess`` on the preview golden's buffer;
- checkpoints written by either renderer, resumed by the other, against the
  writer rendering the same rounds.

The reference is jitted, and XLA contracts multiply-adds (ROADMAP.md C):
after 64 march steps a lane differs from the port by up to ~1e-3 relative,
as much as the reference run eagerly differs from its jitted self. Each
tolerance below is stated beside the measured value it sits under.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu import constants as JC
from digital_earth_tpu.app.config_io import apply_config as japply
from digital_earth_tpu.assets import luts as jluts
from digital_earth_tpu.assets.procgen import generate_earth_textures
from digital_earth_tpu.assets.textures import build_atlas as jax_build_atlas
from digital_earth_tpu.models import surface as jsu
from digital_earth_tpu.models import volume as jv
from digital_earth_tpu.ops import spectral as jsp
from digital_earth_tpu.render import params as jparams
from digital_earth_tpu.render import raymarcher as jrm
from digital_earth_tpu.render import renderer as jrend
from digital_earth_tpu_torch.app.config_io import apply_config, load_config
from digital_earth_tpu_torch.assets import luts as tluts
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.models import surface as tsu
from digital_earth_tpu_torch.models import volume as tv
from digital_earth_tpu_torch.ops import rng
from digital_earth_tpu_torch.ops import spectral as tsp
from digital_earth_tpu_torch.render import film, raygen, raymarcher
from digital_earth_tpu_torch.render import params as tparams
from digital_earth_tpu_torch.render.params import TraceConfig
from digital_earth_tpu_torch.render.renderer import Renderer

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APOLLO = os.path.join(ROOT, "scenes", "config - Apollo 11.txt")
SMALL = dict(max_bounces=3, land_march_steps=64, max_tracking_steps=256)


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def share_close(got, want, rtol, atol=1e-30):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.isclose(got, np.asarray(want), rtol=rtol, atol=atol).mean()


@pytest.fixture(scope="module")
def luts():
    return jluts.load_spectral_luts(), tluts.load_spectral_luts("cpu")


@pytest.fixture(scope="module")
def atlases():
    raw = generate_earth_textures((64, 128), seed=3)
    return jax_build_atlas(raw), build_atlas(raw, "cpu")


# --- ops/rng -----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 7])
def test_split_bit_equal(n):
    for k in np.random.default_rng(n).integers(0, 2**32, (4, 2), dtype=np.uint64):
        want = np.asarray(jax.random.split(jnp.asarray(k, jnp.uint32), n))
        got = rng.split(T(k.astype(np.int64)), n).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("shape", [(), (5,), (2, 9), (3, 4, 2)])
def test_uniform_key_bit_equal(shape):
    for k in np.random.default_rng(len(shape)).integers(0, 2**32, (4, 2), dtype=np.uint64):
        want = np.asarray(jax.random.uniform(jnp.asarray(k, jnp.uint32), shape))
        got = rng.uniform_key(T(k.astype(np.int64)), shape).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# --- element-wise pieces -----------------------------------------------------


def test_spectrum_sample(luts):
    jl, tl = luts
    u = np.concatenate([np.random.default_rng(3).random(4094), [0.0, 1.0 - 2**-24]]).astype(np.float32)
    got = tsp.spectrum_sample(T(u), tl.cie_cdf, tl.cie_response)
    want = jsp.spectrum_sample(jnp.asarray(u), jl.cie_cdf, jl.cie_response)
    # measured: wavelengths within 1.1e-6 relative, responses within 1.5e-6
    # absolute, 1/pdf within 5.7e-5 relative (the CIE lerp's cancellation)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=5e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-3, atol=4e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=2e-4)


def test_earth_brdf():
    n = 8192
    r = np.random.default_rng(4)
    alb, oc, ba = (r.random(n).astype(np.float32) for _ in range(3))
    v, nrm, ldir = _unit(r, n), _unit(r, n), _unit(r, n)
    got = tsu.earth_brdf(T(alb), T(oc), T(ba), T(v), T(nrm), T(ldir))
    want = jsu.earth_brdf(*(jnp.asarray(a) for a in (alb, oc, ba, v, nrm, ldir)))
    for g, w in zip(got, want):  # measured within 3.7e-8 absolute
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("w,h,target", [(32, 18, 576), (64, 36, 256), (480, 270, 2048),
                                        (1920, 1080, 2048)])
def test_block_dims_and_tile_map(w, h, target):
    block = raygen.pick_block_dims(w, h, target)
    assert block == jrend._pick_block_dims(w, h, target)
    n_tiles = (w // block[0]) * (h // block[1])
    pu, pv = jrend._tile_pixel_coords(jnp.arange(n_tiles), (w, h), block)
    lane = torch.arange(w * h)
    tidx, li, tpu, tpv = raygen.tile_pixel_coords(lane, (w, h), block)
    np.testing.assert_array_equal(tpu.numpy(), np.asarray(pu))
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(pv))
    assert torch.equal(tidx * block[0] * block[1] + li, lane)
    assert len(set((tpu * h + tpv).tolist())) == w * h  # a bijection onto pixels


# --- the atmosphere march ----------------------------------------------------


def _march_lanes(n, luts):
    """Lanes from orbit and from inside the atmosphere toward the planet and
    the limb, sun directions around the view direction, one wavelength."""
    jl, _ = luts
    r = np.random.default_rng(5)
    h = n // 2
    pos = np.concatenate([
        _unit(r, h) * (JC.PLANET_R + r.uniform(150e3, 3e7, (h, 1))),
        _unit(r, n - h) * (JC.PLANET_R + r.uniform(0.0, 100e3, (n - h, 1))),
    ]).astype(np.float32)
    tgt = _unit(r, n) * (JC.PLANET_R + r.uniform(-50e3, 120e3, (n, 1)))
    dirs = tgt - pos
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    sun = _unit(r, n)
    wl = r.uniform(390.0, 830.0, n).astype(np.float32)
    ext = np.stack([np.asarray(jv.spectra_extinction_rayleigh(jnp.asarray(wl))),
                    np.asarray(jv.spectra_extinction_mie(jnp.asarray(wl))),
                    np.asarray(jv.spectra_extinction_ozone(jnp.asarray(wl), jl.o3_crossec))],
                   axis=-1)
    scat = np.stack([ext[:, 0] * JC.RAYLEIGH_ALBEDO, ext[:, 1] * JC.AEROSOL_ALBEDO], axis=-1)
    return pos, dirs, sun, wl, ext.astype(np.float32), scat.astype(np.float32)


def test_ray_march_transmittance(luts):
    pos, _, sun, _, ext, _ = _march_lanes(4096, luts)
    got = raymarcher.ray_march_transmittance(T(pos), T(sun), T(ext)).numpy()
    want = np.asarray(jrm._ray_march_transmittance(jnp.asarray(pos), jnp.asarray(sun),
                                                   jnp.asarray(ext)))
    assert (got == 0).mean() == pytest.approx((want == 0).mean())  # occlusion
    # measured: 0.9932 of lanes within 1e-5 relative, all within 1.3e-3
    # (grazing chords through the 16 steps)
    assert share_close(got, want, rtol=1e-5) >= 0.99
    np.testing.assert_allclose(got, want, rtol=4e-3, atol=1e-30)


def test_ray_march_atmos(luts):
    pos, dirs, sun, _, ext, scat = _march_lanes(4096, luts)
    b = (pos * dirs).sum(-1)
    c = (pos * pos).sum(-1) - np.float32(JC.ATMOS_UPPER_LIMIT) ** 2
    disc = np.maximum(b * b - c, 0.0)
    t0 = np.maximum(-b - np.sqrt(disc), 0.0).astype(np.float32)
    t1 = np.where(b * b - c < 0, -1.0, -b + np.sqrt(disc)).astype(np.float32)
    active = t1 >= 0.0
    got = raymarcher.ray_march_atmos_plain(T(pos), T(dirs), T(t0), T(t1), T(sun), T(ext),
                                           T(scat), T(active))
    want = jrm._ray_march_atmos(*(jnp.asarray(a) for a in (pos, dirs, t0, t1, sun, ext, scat)))
    for g, w in zip(got, want):
        g, w = g.numpy()[active], np.asarray(w)[active]
        atol = 1e-6 * np.abs(w).max()
        # Grazing sun chords turn a one-ulp position into 1e-3 of the
        # in-scatter: against a float64 run of the same march, port and
        # reference both err by up to 3.5e-2 (99th percentile 1e-3).
        # measured: 0.99927 (in-scatter) and 1.0 (transmittance) of lanes
        # within 1e-4 relative, every lane within 4.2e-4 (with an atol of
        # 1e-6 of the largest value)
        assert share_close(g, w, rtol=1e-4, atol=atol) >= 0.998
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol)


def test_march_paths(luts, atlases):
    jl, tl = luts
    jatlas, tatlas = atlases
    n = 2048
    r = np.random.default_rng(6)
    cfg = load_config(APOLLO)  # its camera and sun: a lit disk with a limb
    cam = np.asarray(cfg.camera_pos)
    tgt = _unit(r, n) * JC.PLANET_R * r.uniform(0.9, 1.03, (n, 1))
    tgt = tgt * np.sign((tgt * cam).sum(-1, keepdims=True))  # the near side
    dirs = tgt - cam
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    pos = np.broadcast_to(cam, (n, 3)).astype(np.float32)
    wl = r.uniform(390.0, 830.0, n).astype(np.float32)
    key = np.array([0, 11], np.uint32)
    jscene = jparams.make_scene_params(cfg.sun_angle, cfg.sun_path_rot, 7800.0)
    tscene = tparams.make_scene_params("cpu", cfg.sun_angle, cfg.sun_path_rot, 7800.0)
    want = np.asarray(jrm.march_paths(jnp.asarray(key), jnp.asarray(pos), jnp.asarray(dirs),
                                      jnp.asarray(wl), jscene, jatlas, jl,
                                      jparams.TraceConfig(**SMALL)))
    got = raymarcher.march_paths_plain(T(key.astype(np.int64)), T(pos), T(dirs), T(wl), tscene,
                                       tatlas, tl, TraceConfig(**SMALL)).numpy()
    assert np.isfinite(got).all() and (got > 0).mean() > 0.8  # measured 0.883
    # measured: 0.906 of lanes within 1e-3 relative, 0.992 within 1e-2,
    # means within 5.5e-5. The reference run eagerly reads 0.912 / 0.998
    # against its jitted self on these lanes, and the port 0.989 / 0.993
    # against the eager reference (XLA's multiply-add contraction).
    assert share_close(got, want, rtol=1e-3) >= 0.89
    assert share_close(got, want, rtol=1e-2) >= 0.98
    assert got.mean() == pytest.approx(want.mean(), rel=5e-4)


def _apollo_lanes(n, seed):
    """n camera rays of Apollo 11 toward the near side of the disk and its
    limb, with wavelengths: (pos, dirs, wl, cpu scene)."""
    r = np.random.default_rng(seed)
    cfg = load_config(APOLLO)
    cam = np.asarray(cfg.camera_pos)
    tgt = _unit(r, n) * JC.PLANET_R * r.uniform(0.9, 1.03, (n, 1))
    tgt = tgt * np.sign((tgt * cam).sum(-1, keepdims=True))
    dirs = tgt - cam
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    pos = np.ascontiguousarray(np.broadcast_to(cam, (n, 3)).astype(np.float32))
    wl = r.uniform(390.0, 830.0, n).astype(np.float32)
    scene = tparams.make_scene_params("cpu", cfg.sun_angle, cfg.sun_path_rot, 7800.0)
    return T(pos), T(dirs), T(wl), scene


@pytest.mark.parametrize("tiled", [False, True])
def test_march_paths_on_cpu_is_the_twin(luts, atlases, tiled):
    """On CPU tensors march_paths is march_paths_plain, bit for bit, and
    launches no kernel; with one tile key and with an spp key and tiles."""
    from digital_earth_tpu_torch import kernels

    _, tl = luts
    n = 384
    pos, dirs, wl, scene = _apollo_lanes(n, 8)
    key = torch.tensor([0, 11], dtype=torch.int64)
    kw = {}
    if tiled:  # 8 tiles of 48 lanes, in a scrambled tile order
        lane = torch.arange(n)
        kw = dict(tile_index=(lane // 48) * 37 + 5, lane=lane % 48, tile=48)
    before = kernels.preview.launches
    got = raymarcher.march_paths(key, pos, dirs, wl, scene, atlases[1], tl,
                                 TraceConfig(**SMALL), **kw)
    want = raymarcher.march_paths_plain(key, pos, dirs, wl, scene, atlases[1], tl,
                                        TraceConfig(**SMALL), **kw)
    assert kernels.preview.launches == before
    assert (want > 0).float().mean().item() > 0.5
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("bilinear", [True, False])
def test_preview_frame_blocks(luts, atlases, bilinear):
    """PreviewFrame's float block holds the twin's own float32 scalars: the
    scene's, offset_scale and the march floor as the twin computes and
    passes them, the Planck constants reproducing sp.plancks bit for bit,
    the albedos and the phase constants; its int block the march budget,
    the tile, the texture shapes and the march options (at their
    defaults)."""
    from digital_earth_tpu_torch import constants as C
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import math_utils as mu
    from digital_earth_tpu_torch.render.tracers import _march_floor

    _, tl = luts
    atlas = atlases[1]
    cfg = TraceConfig(**SMALL, bilinear_materials=bilinear)
    _, _, wl, scene = _apollo_lanes(4096, 9)
    frame = raymarcher.PreviewFrame(scene, atlas, tl, cfg, 192)
    fp = np.asarray(frame.fparams, dtype=np.float32)  # as ctypes passes them
    assert len(frame.fparams) == kernels.PREVIEW_FLOATS
    scale = scene.land_height_scale
    step_floor, stall, _ = _march_floor(atlas.topography, cfg)
    want = [scale, step_floor, stall, *scene.light_direction, scene.sun_cos_angle,
            mu.cone_angle_to_solid_angle(scene.sun_angular_radius),
            1.0 + 0.0001 * scale / 12000.0]
    np.testing.assert_array_equal(fp[:9], np.array([float(x) for x in want], np.float32))
    a, b, k, t_sun, t_nl, nl_scale, stars_scale, alb_r, alb_m = (
        torch.tensor(x) for x in fp[9:18])

    def planck(t):  # csrc/spectral.cuh plancks, op by op
        wl2 = wl * wl
        return (a / (wl * (wl2 * wl2))) / (torch.exp(b / ((wl * k) * t)) - 1.0)

    bits = lambda x: x.view(torch.int32)  # noqa: E731
    assert torch.equal(bits(planck(t_sun)), bits(tsp.plancks(C.SUN_TEMPERATURE, wl)))
    assert torch.equal(bits(planck(t_nl) * nl_scale),
                       bits(tsp.plancks(C.NIGHTLIGHT_TEMPERATURE, wl) * C.NIGHTLIGHT_SCALE))
    assert float(stars_scale) == np.float32(C.STARS_SCALE)
    ext = torch.stack([tv.spectra_extinction_rayleigh(wl), tv.spectra_extinction_mie(wl)], -1)
    assert torch.equal(ext[:, 0] * alb_r, ext[:, 0] * C.RAYLEIGH_ALBEDO)
    assert torch.equal(ext[:, 1] * alb_m, ext[:, 1] * C.AEROSOL_ALBEDO)
    np.testing.assert_array_equal(fp[18:], np.array(
        [3.0 / (16.0 * np.pi), C.MIE_ASYMMETRY, 2.0 * np.pi,
         torch.log(torch.tensor(2.0 * C.MIE_ASYMMETRY + 1.0)).item()], np.float32))
    assert frame.iparams == [cfg.land_march_steps, cfg.march_k, cfg.march_stall_patience,
                             int(bilinear), 192, *atlas.topography.shape[:2],
                             *atlas.material.shape[:2], *atlas.stars.shape[:2], 1, 0, 1, 1]
    assert len(frame.iparams) == kernels.PREVIEW_INTS


@pytest.mark.parametrize("k", [3, 64])
def test_preview_kernel_refuses_march_k_off_the_warp(k):
    """The preview kernel's land and shadow marches spread a lane's march_k
    probes over march_k threads of a warp: its wrapper rejects a march_k
    that does not divide 32 before any launch (the plain twin takes any)."""
    from digital_earth_tpu_torch import kernels

    n = 4
    iparams = [8, k, 5, 0, n, 8, 16, 8, 16, 8, 16, 1, 0, 1, 1]
    with pytest.raises(ValueError, match="divide 32"):
        kernels.preview([0.0] * kernels.PREVIEW_FLOATS, iparams, (0, 0), None,
                        torch.zeros((n, 3)), torch.zeros(n), None, None,
                        torch.zeros((8, 16, 4), dtype=torch.uint8),
                        torch.zeros((8, 16, 8), dtype=torch.uint8),
                        torch.zeros((8, 16, 3), dtype=torch.uint8), torch.zeros(441),
                        torch.zeros((300, 3)), origin=(0.0, 0.0, 0.0))


def preview_draws_recipe(spp_key, tidx: int, li: int, tile: int):
    """The preview kernel's key recipe for one lane in Python integers
    (csrc/preview.cu): the tile key fold(spp_key, tidx); bounce b's key
    fold^b(tile key, 2); its cone and hemisphere keys fold(., 0) and
    fold(., 1), each read at li and tile + li. Returns [(cone u0, cone u1,
    hemi u0, hemi u1)] for bounces 0, 1, 2."""
    def fold(k, d):
        return rng.threefry2x32(k[0], k[1], 0, d & rng.M32)

    def uniform(k, j):
        y0, y1 = rng.threefry2x32(k[0], k[1], 0, j & rng.M32)
        word = np.array([((y0 ^ y1) >> 9) | 0x3F800000], np.uint32)
        return word.view(np.float32)[0] - np.float32(1.0)

    kb = fold(spp_key, tidx)
    out = []
    for b in range(3):
        if b:
            kb = fold(kb, 2)
        kc, kh = fold(kb, 0), fold(kb, 1)
        out.append((uniform(kc, li), uniform(kc, tile + li), uniform(kh, li),
                    uniform(kh, tile + li)))
    return out


@pytest.mark.parametrize("res,tile_pixels,tile_list", [((480, 270), 2048, False),
                                                        ((64, 36), 192, True)])
def test_preview_key_recipe(res, tile_pixels, tile_list):
    """The kernel's recipe (spp key, tile index, in-tile index, tile -> the
    draws of each bounce) against _bounce_draws(rng.lane_keys(...)), bit for
    bit, on lanes of a frame (or of a tile list) at round 3 of seed 9."""
    block = raygen.pick_block_dims(*res, tile_pixels)
    tile = block[0] * block[1]
    n_tiles = (res[0] // block[0]) * (res[1] // block[1])
    tile_ids = (torch.randperm(n_tiles, generator=torch.Generator().manual_seed(1))[:4]
                if tile_list else None)
    n = (4 if tile_list else n_tiles) * tile
    lane = torch.from_numpy(np.random.default_rng(2).choice(n, 48, replace=False))
    tidx, li, _, _ = raygen.tile_pixel_coords(lane, res, block, tile_ids)
    spp_key = rng.fold(torch.tensor((0, 9), dtype=torch.int64), 3)
    want = raymarcher._bounce_draws(rng.lane_keys(spp_key, tidx), li, tile).numpy()
    k = tuple(int(x) for x in spp_key.tolist())
    for j in range(lane.numel()):
        got = np.array(preview_draws_recipe(k, int(tidx[j]), int(li[j]), tile), np.float32)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want[:, :, :, j].reshape(3, 4).view(np.int32))


# --- the preview renderer ----------------------------------------------------


def test_preview_golden(atlases):
    golden = np.load(os.path.join(ROOT, "tests", "golden", "apollo_preview.npz"))
    r = Renderer("cpu", image_res=(32, 18), atlas=atlases[1], tile_pixels=576, seed=0,
                 cfg=TraceConfig(**SMALL), mode="preview")
    apply_config(r, load_config(APOLLO))
    for _ in range(int(golden["spp"])):
        r.accumulate()
    buf, ref = r.color_buffer.numpy(), golden["color_buffer"]
    # measured: 0.9948 of pixels within rtol 1e-3, channel means within 9.7e-5
    assert np.isclose(buf, ref, rtol=1e-3, atol=1e-7).all(-1).mean() >= 0.99
    np.testing.assert_allclose(buf.mean((0, 1)), ref.mean((0, 1)), rtol=1e-3)


def test_postprocess_preview_golden():
    golden = np.load(os.path.join(ROOT, "tests", "golden", "apollo_preview.npz"))
    cfg = load_config(APOLLO)
    img = film.postprocess(torch.from_numpy(golden["color_buffer"]), float(golden["spp"]),
                           cfg.exposure, cfg.gamma, tluts.load_crf_pack("cpu").curves,
                           cfg.crf_index).numpy()
    np.testing.assert_allclose(img, golden["image"], atol=1e-4)


@pytest.fixture(scope="module")
def preview_pair(atlases):
    """The JAX and the port preview renderers, 64x36 in 16x12 tiles."""
    jatlas, tatlas = atlases
    jr = jrend.Renderer(image_res=(64, 36), atlas=jatlas, tile_pixels=256, mode="preview",
                        cfg=jparams.TraceConfig(**SMALL))
    tr = Renderer("cpu", image_res=(64, 36), atlas=tatlas, tile_pixels=256, mode="preview",
                  cfg=TraceConfig(**SMALL))
    cfg = load_config(APOLLO)
    japply(jr, cfg)
    apply_config(tr, cfg)
    assert jr.block == tr.block == (16, 12)
    return jr, tr


def _agree(got, want):
    """(share of pixels within rtol 1e-3, largest channel-mean difference)."""
    share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    return share, np.abs(got.mean((0, 1)) / want.mean((0, 1)) - 1.0).max()


def test_preview_matches_live_jax_renderer(preview_pair):
    jr, tr = preview_pair
    jr.reset_framebuffer()
    tr.reset_framebuffer()
    for _ in range(2):
        jr.accumulate()
        tr.accumulate()
    share, mean_err = _agree(tr.color_buffer.numpy(), np.asarray(jr.color_buffer))
    # measured: 0.950 of pixels within rtol 1e-3, channel means within 1.3e-4
    assert share >= 0.93 and mean_err <= 1e-3, (share, mean_err)


def test_jax_checkpoint_resumes_in_port(preview_pair, tmp_path):
    jr, tr = preview_pair
    jr.reset_framebuffer()
    jr.accumulate()
    path = str(tmp_path / "jax.npz")
    jr.save_checkpoint(path)
    tr.load_checkpoint(path)
    assert (tr.current_spp, tr._rng_round, tr.total_samples) == (1, 1, 64 * 36)
    np.testing.assert_array_equal(tr.color_buffer.numpy(), np.asarray(jr.color_buffer))
    jr.accumulate()
    tr.accumulate()
    share, mean_err = _agree(tr.color_buffer.numpy(), np.asarray(jr.color_buffer))
    # measured: 0.970 of pixels within rtol 1e-3, channel means within 1.2e-4
    assert share >= 0.95 and mean_err <= 1e-3, (share, mean_err)


def test_port_checkpoint_resumes_in_jax(preview_pair, tmp_path):
    jr, tr = preview_pair
    tr.reset_framebuffer()
    tr.accumulate()
    path = str(tmp_path / "port.npz")
    tr.save_checkpoint(path)
    jr.load_checkpoint(path)
    assert (jr.current_spp, jr._rng_round, jr.mean_spp) == (1, 1, 1.0)
    np.testing.assert_array_equal(np.asarray(jr.color_buffer), tr.color_buffer.numpy())
    jr.accumulate()
    tr.accumulate()
    share, mean_err = _agree(tr.color_buffer.numpy(), np.asarray(jr.color_buffer))
    # measured: 0.970 of pixels within rtol 1e-3, channel means within 1.2e-4
    assert share >= 0.95 and mean_err <= 1e-3, (share, mean_err)


# --- the scene's host record and the kept preview frame -------------------------

SCENES = ("config - Apollo 11.txt", "config - florida.txt", "config - sunset hurricane.txt")


def _read_back(scene):
    """The kernels' scene scalars as they were read from the tensors before
    the scene carried them: the twins' own float32 arithmetic on the scene's
    device, then one ``.tolist()``."""
    from digital_earth_tpu_torch.ops import math_utils as mu

    scale = scene.land_height_scale
    return torch.stack([scale, *scene.light_direction, scene.sun_cos_angle,
                        mu.cone_angle_to_solid_angle(scene.sun_angular_radius),
                        1.0 + 0.0001 * scale / 12000.0]).tolist()


def _flat(host):
    return [host.land_height_scale, *host.light_direction, host.sun_cos_angle,
            host.solid_angle, host.offset_scale]


def _bits(values):
    return np.asarray(values, np.float32).view(np.int32)


@pytest.mark.parametrize("sliders", [None, (0.31, -1.2, 2000.0), (2.9, 0.75, 15000.0)])
@pytest.mark.parametrize("scene", SCENES)
def test_host_scene_is_the_tensors_read_back(atlases, scene, sliders):
    """The scene's host record holds, bit for bit, what the kernels' scalars
    read back from its tensors were; scene_floats returns it."""
    from digital_earth_tpu_torch.render import pathtracer as pt

    r = Renderer("cpu", image_res=(32, 18), atlas=atlases[1], mode="preview")
    apply_config(r, load_config(os.path.join(ROOT, "scenes", scene)))
    if sliders is not None:
        r.set_sun_angle(sliders[0])
        r.set_sun_path_rot(sliders[1])
        r.set_land_height_scale(sliders[2])
    s = r.scene_params()
    np.testing.assert_array_equal(_bits(_flat(s.host)), _bits(_read_back(s)))
    assert pt.scene_floats(s) == tuple(s.host)
    assert all(isinstance(x, float) for x in _flat(s.host))


@pytest.mark.parametrize("scene,scale", [(s, h) for s in SCENES[:2] for h in (7800.0, 2500.0)])
def test_converted_scene_carries_its_host_record(scene, scale):
    """A scene carried over from JAX has the host record of its tensors."""
    from digital_earth_tpu_torch import convert

    cfg = load_config(os.path.join(ROOT, "scenes", scene))
    conv = convert.scene_params_to_torch(
        jparams.make_scene_params(cfg.sun_angle, cfg.sun_path_rot, scale), "cpu")
    np.testing.assert_array_equal(_bits(_flat(conv.host)), _bits(_read_back(conv)))


def _on_meta(scene):
    return tparams.SceneParams(*(getattr(scene, f).to("meta") for f in tparams.SCENE_TENSORS),
                               host=scene.host)


@pytest.mark.parametrize("bilinear", [True, False])
def test_frames_read_no_scene_tensor(luts, atlases, bilinear):
    """PreviewFrame and BounceFrame build from a scene whose tensors lie on
    ``meta`` (they hold no data) the same blocks as from the CPU scene: they
    read the host record alone, so neither reads the card."""
    from digital_earth_tpu_torch.render import pathtracer as pt

    _, tl = luts
    atlas = atlases[1]
    cfg = TraceConfig(**SMALL, bilinear_materials=bilinear)
    scene = tparams.make_scene_params("cpu", 1.1, -0.4, 9000.0)
    meta = _on_meta(scene)
    assert meta.light_direction.is_meta and meta.land_height_scale.is_meta
    want = raymarcher.PreviewFrame(scene, atlas, tl, cfg, 192)
    got = raymarcher.PreviewFrame(meta, atlas, tl, cfg, 192)
    assert (got.fparams, got.iparams) == (want.fparams, want.iparams)
    n = 64
    r = np.random.default_rng(2)
    st = pt.init_state(T(_unit(r, n) * 7e6), T(_unit(r, n)), T(r.uniform(400, 700, (n, 4))),
                       torch.ones((n, 4)), torch.zeros((n, 2), dtype=torch.int64))
    want = pt.BounceFrame(st, scene, atlas, tl, cfg)
    got = pt.BounceFrame(st, meta, atlas, tl, cfg)
    assert (got.fparams, got.iparams) == (want.fparams, want.iparams)


def _preview_renderer(atlas):
    r = Renderer("cpu", image_res=(32, 18), atlas=atlas, tile_pixels=192, seed=4,
                 cfg=TraceConfig(**SMALL), mode="preview")
    apply_config(r, load_config(APOLLO))
    return r


def test_renderer_keeps_the_preview_frame(atlases, monkeypatch):
    """The Renderer builds the preview kernel's blocks once for several
    frames, and again once a slider has moved."""
    built = []

    class Counted(raymarcher.PreviewFrame):
        def __init__(self, *args, **kwargs):
            built.append(args[-1])
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(raymarcher, "PreviewFrame", Counted)
    r = _preview_renderer(atlases[1])
    r.accumulate()
    r.accumulate_interruptible(3)
    assert built == [r.tile]
    r.set_sun_angle(r.sun_angle + 0.2)
    r.accumulate()
    assert built == [r.tile, r.tile]


def test_preview_frame_bit_equal_with_the_kept_blocks(atlases, monkeypatch):
    """A 32x18 preview frame (three 192-pixel tiles) is the same, bit for
    bit, with the Renderer's kept blocks as with blocks built on each call.
    On the CPU the twin takes no blocks, so this covers the frame's other
    host-side changes: the origin from the host camera and the spp key
    folded on the host (tests/test_torch_kernels_cuda.py holds the kept
    blocks against fresh ones on the card)."""
    from digital_earth_tpu_torch.render import renderer as trenderer

    kept, fresh = _preview_renderer(atlases[1]), _preview_renderer(atlases[1])
    kept.accumulate()
    monkeypatch.setattr(trenderer.Renderer, "_frame", lambda self, scene: None)
    fresh.accumulate()
    assert kept._preview_frame is not None and fresh._preview_frame is None
    assert torch.equal(kept.color_buffer.view(torch.int32), fresh.color_buffer.view(torch.int32))
