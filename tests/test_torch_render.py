"""The PyTorch port's renderer end to end on the CPU:

- the three golden scenes (tests/golden/*_path.npz, made by
  tools/gen_golden.py from the jitted JAX renderer) rendered by the port
  with the same atlas, config, seed and spp. Both sides draw the same
  random streams, so only rounding separates them, but at rtol 1e-3 that
  is a wide spread: the reference run eagerly against its own jitted
  goldens reads 0.958 (apollo), 0.915 (florida), 0.755 (sunset) of pixels
  within rtol 1e-3 (test_torch_bounce.py says why). The port reads 0.929,
  0.925, 0.764; stated floors 0.92, 0.89, 0.73, and every channel's frame
  mean within 3% (measured at most 1.7%);
- the same three scenes at the DEFAULT ``TraceConfig()`` (25 bounces,
  250-probe march, 8192-step cap), 48x27, 1 spp, against the JAX renderer
  run live on the same atlas: measured shares 0.96 / 0.95 / 0.82, stated
  floors 0.95 (apollo), 0.90 (florida), 0.75 (sunset), means within 5%;
- the port's film chain on each golden buffer reproduces the golden image
  to atol 1e-4 (no random numbers involved);
- importing every port module loads neither ``jax`` nor any module of the
  JAX package.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.app.config_io import load_config
from digital_earth_tpu.assets.procgen import generate_earth_textures
from digital_earth_tpu.render import film as jfilm
from digital_earth_tpu_torch.app.viewer import render_offline
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.render import film
from digital_earth_tpu_torch.render.params import TraceConfig
from digital_earth_tpu_torch.render.renderer import Renderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SCENES = {
    "apollo": ("config - Apollo 11.txt", 0.92),
    "florida": ("config - florida.txt", 0.89),
    "sunset": ("config - sunset hurricane.txt", 0.73),
}
GOLDEN_CFG = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256)


@pytest.fixture(scope="module")
def atlas():
    return build_atlas(generate_earth_textures((64, 128), seed=3), "cpu")


def _render(atlas, scene, spp):
    return render_offline(
        load_config(os.path.join(ROOT, "scenes", SCENES[scene][0])), "cpu",
        spp=spp, image_res=(32, 18), out_path=None, atlas=atlas, seed=0,
        cfg=GOLDEN_CFG,
    )


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_golden_scene_statistically(atlas, scene):
    golden = np.load(os.path.join(GOLDEN, f"{scene}_path.npz"))
    r = _render(atlas, scene, int(golden["spp"]))
    buf = r.color_buffer.numpy()
    ref = golden["color_buffer"]
    assert np.isfinite(buf).all() and buf.shape == ref.shape
    share = np.isclose(buf, ref, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= SCENES[scene][1], share
    np.testing.assert_allclose(buf.mean((0, 1)), ref.mean((0, 1)), rtol=0.03)


DEFAULT_FLOORS = {"apollo": 0.95, "florida": 0.90, "sunset": 0.75}


@pytest.fixture(scope="module")
def default_atlases():
    from digital_earth_tpu.assets.textures import build_atlas as jax_build_atlas

    raw = generate_earth_textures((256, 512), seed=7)
    return jax_build_atlas(raw), build_atlas(raw, "cpu")


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_default_config_matches_jax_renderer(default_atlases, scene):
    from digital_earth_tpu.app.config_io import apply_config
    from digital_earth_tpu.render.renderer import Renderer as JaxRenderer

    jatlas, tatlas = default_atlases
    cfg = load_config(os.path.join(ROOT, "scenes", SCENES[scene][0]))
    ref = JaxRenderer(image_res=(48, 27), atlas=jatlas, tile_pixels=1296)
    apply_config(ref, cfg)
    ref.accumulate()
    want = np.asarray(ref.color_buffer)
    got = render_offline(cfg, "cpu", spp=1, image_res=(48, 27), out_path=None,
                         atlas=tatlas).color_buffer.numpy()
    share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= DEFAULT_FLOORS[scene], share
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.05)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_postprocess_reproduces_golden_image(scene):
    golden = np.load(os.path.join(GOLDEN, f"{scene}_path.npz"))
    r = Renderer("cpu", image_res=(32, 18), atlas=build_atlas(
        generate_earth_textures((8, 16), seed=3), "cpu"))
    cfg = load_config(os.path.join(ROOT, "scenes", SCENES[scene][0]))
    img = film.postprocess(
        torch.from_numpy(golden["color_buffer"]), float(golden["spp"]),
        cfg.exposure, cfg.gamma, r.crf.curves, cfg.crf_index,
    ).numpy()
    np.testing.assert_allclose(img, golden["image"], atol=1e-4)


def test_agx_matches_jax():
    x = np.random.default_rng(0).uniform(0.0, 4.0, (4096, 3)).astype(np.float32)
    np.testing.assert_allclose(
        film.agx_transform(torch.from_numpy(x)).numpy(),
        np.asarray(jfilm.agx_transform(jnp.asarray(x))), atol=1e-4,
    )


def test_accumulate_is_deterministic_and_resets(atlas):
    a = _render(atlas, "apollo", 1)
    b = _render(atlas, "apollo", 1)
    assert torch.equal(a.color_buffer, b.color_buffer)
    a.reset_framebuffer()
    assert a.current_spp == 0 and float(a.color_buffer.abs().sum()) == 0.0
    img = b.fetch_image_np()
    assert img.shape == (18, 32, 3) and img.dtype == np.uint8


def test_render_offline_writes_png(atlas, tmp_path):
    out = tmp_path / "apollo.png"
    render_offline(
        load_config(os.path.join(ROOT, "scenes", "config - Apollo 11.txt")), "cpu",
        spp=1, image_res=(16, 9), out_path=str(out), atlas=atlas,
        cfg=TraceConfig(max_bounces=2, land_march_steps=32, max_tracking_steps=64),
    )
    assert out.stat().st_size > 0


def test_port_never_imports_jax():
    """Importing every port module loads neither ``jax`` nor any module of
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import digital_earth_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "ref = sorted(k for k in sys.modules if k.split('.')[0] == 'digital_earth_tpu')\n"
        "assert not ref, ref\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
