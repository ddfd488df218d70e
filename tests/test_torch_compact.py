"""The port's binned live-lane list against the JAX stage compactor, and the
bounce schedule's independence of it.

``compact_by_alive_plain`` (the plain twin of the ``compact_lanes`` kernel)
must give the alive lanes in the order of the reference's
``_compact_by_alive`` (renderer.py:84): bin by work class, stable within a
bin (exact). ``run_bounces`` on the CPU with the binned list must leave the
same state as with the live lanes in lane order: every draw is keyed per
lane, so the schedule does not change the image. Stated tolerance: the same
``alive`` and ``work_class`` on every lane, every value within rtol 1e-5.
Not bit-equality: PyTorch's CPU kernels may round a lane's transcendental
differently depending on whether it falls in a vector or in the scalar tail.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.render.renderer import _compact_by_alive
from digital_earth_tpu_torch.app.config_io import apply_config, load_config
from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.render import compact
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render import raygen
from digital_earth_tpu_torch.render.params import TraceConfig
from digital_earth_tpu_torch.render.renderer import Renderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(n, kind, seed):
    r = np.random.default_rng(seed)
    alive = r.random(n) < 0.6
    wc = r.integers(-1, 5, n).astype(np.int32)  # out-of-range classes clip
    if kind == "all_alive":
        alive[:] = True
    elif kind == "all_dead":
        alive[:] = False
    elif kind == "one_bin_empty":
        wc = np.where(wc == 1, 2, wc).astype(np.int32)
    return alive, wc


@pytest.mark.parametrize("kind", ["mixed", "all_alive", "all_dead", "one_bin_empty"])
@pytest.mark.parametrize("n", [1, 1000, 4099])
def test_compact_matches_jax(n, kind):
    alive, wc = _case(n, kind, seed=n)
    idx, n_live = compact.compact_by_alive_plain(torch.from_numpy(alive), torch.from_numpy(wc))
    _, src = _compact_by_alive(jnp.zeros(n), jnp.asarray(alive), jnp.asarray(wc))
    m = int(alive.sum())
    assert idx.dtype == torch.int32 and n_live.dtype == torch.int32
    assert int(n_live) == m
    np.testing.assert_array_equal(idx.numpy()[:m], np.asarray(src)[:m])
    # the list is the wrapper's on the CPU
    got, got_n = compact.compact_by_alive(torch.from_numpy(alive), torch.from_numpy(wc))
    assert torch.equal(got, idx) and torch.equal(got_n, n_live)


def _bounce0_state(scene):
    """The 32x18 frame's bounce-0 wavefront of ``scene`` (golden setup)."""
    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), "cpu")
    cfg = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256)
    r = Renderer("cpu", image_res=(32, 18), atlas=atlas, seed=0, cfg=cfg)
    apply_config(r, load_config(os.path.join(ROOT, "scenes", scene)))
    res = r.image_res
    n = res[0] * res[1]
    rays = raygen.gen_rays(r._seed_key, 0, 0, n, res, (1, res[1]), r.camera_params(), r.luts,
                           False)
    pos = r.camera_params().position.expand(n, 3).contiguous()
    st = pt.init_state(pos, rays.dirs, rays.wavelengths, rays.pdf, rays.keys)
    return st, r, cfg


def _clone(st):
    return pt.TraceState(**{k: v.clone() for k, v in vars(st).items()})


@pytest.mark.parametrize("scene", ["config - Apollo 11.txt", "config - florida.txt"])
def test_run_bounces_does_not_depend_on_the_lane_order(scene, monkeypatch):
    st, r, cfg = _bounce0_state(scene)
    args = (r.scene_params(), r.atlas, r.luts, cfg, 0, cfg.max_bounces)
    binned = pt.run_bounces(_clone(st), *args)
    classes = set(binned.work_class[binned.alive].tolist())

    def lane_order(alive, work_class):
        live = torch.nonzero(alive).squeeze(1).to(torch.int32)
        return live, torch.tensor([live.numel()], dtype=torch.int32)

    monkeypatch.setattr(compact, "compact_by_alive", lane_order)
    plain = pt.run_bounces(_clone(st), *args)
    assert torch.equal(binned.alive, plain.alive)
    assert torch.equal(binned.work_class, plain.work_class)
    assert torch.equal(binned.primary_miss, plain.primary_miss)
    for name in ("pos", "direction", "throughput", "radiance", "w_mis"):
        got, want = getattr(binned, name), getattr(plain, name)
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0, msg=name)
    assert binned.alive.any() and classes  # lanes of at least one class survive
