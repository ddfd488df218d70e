"""The preview path of the PyTorch port against the JAX package on the CPU,
on the same numpy-seeded inputs:

- ``rng.split`` / ``uniform_key`` bit-equal to ``jax.random``;
- ``spectrum_sample`` (the preview's single wavelength) and ``earth_brdf``;
- ``pick_block_dims`` and the tile-major lane map equal to the reference's
  ``_pick_block_dims`` / ``_tile_pixel_coords``;
- the two atmosphere-march twins (``_ray_march_transmittance``,
  ``_ray_march_atmos``) on 4096 lanes, and ``march_paths`` on 2048 lanes of
  one tile key, against the reference functions;
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
    got = raymarcher.march_paths(T(key.astype(np.int64)), T(pos), T(dirs), T(wl), tscene,
                                 tatlas, tl, TraceConfig(**SMALL)).numpy()
    assert np.isfinite(got).all() and (got > 0).mean() > 0.8  # measured 0.883
    # measured: 0.906 of lanes within 1e-3 relative, 0.992 within 1e-2,
    # means within 5.5e-5. The reference run eagerly reads 0.912 / 0.998
    # against its jitted self on these lanes, and the port 0.989 / 0.993
    # against the eager reference (XLA's multiply-add contraction).
    assert share_close(got, want, rtol=1e-3) >= 0.89
    assert share_close(got, want, rtol=1e-2) >= 0.98
    assert got.mean() == pytest.approx(want.mean(), rel=5e-4)


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
