"""Multi-device rendering in the PyTorch port (parallel/mesh.py) against the
port's single-device ``Renderer`` and the JAX package's
``digital_earth_tpu.parallel.mesh``, on the CPU: meshes over ``[cpu] * n``
(a device may repeat, as XLA's virtual host devices do for the JAX side),
32x8 and 16x8 frames, ``TraceConfig(max_bounces=4, land_march_steps=64,
max_tracking_steps=512)`` and the 128x256 procedural atlas, as
tests/test_parallel.py uses.

- A (4, 1) mesh against the ``Renderer`` over 2 spp: bit-equal at 16x8. On
  the CPU a lane's ``atan2``/``pow`` can move by an ulp with its place in its
  wavefront (PyTorch runs Sleef on the body of a vector loop and scalar libm
  on the tail), and a shard's wavefront is a quarter of the frame's: at
  32x8, 1 of 256 pixels differs, by 4.5e-8 (measured). The stated gate
  there is every value within rtol 1e-5 (atol 1e-7) and 0.99 of pixels
  bit-equal. On the card each lane runs alone in its thread, and
  chip_smoke.py holds the (4, 1) mesh bit-equal at 1920x1080.
- A (2, 2) step against two (4, 1) steps within rtol 1e-5, atol 1e-7 (the
  JAX gate, tests/test_parallel.py:174-190); chunks bit-equal to the whole
  step (measured); an abort leaves the state as it was.
- The per-device adaptive pass: warm-up counts 2, exactly ``k_local`` tiles
  per device, ``accumulate()`` routed through it; the shard selection's twin
  gives ``lax.top_k``'s ids on seeded shards with ties, +inf and NaN
  scores; one port pass refines the same pixels as one JAX
  ``make_sharded_adaptive_step`` pass on the same seeded buffers.
- The port's (4, 1) frame against the JAX ``MultiChipRenderer`` on 4 of the
  8 CPU devices, same seed and pose: share of pixels within rtol 1e-3
  (measured 0.984, stated floor 0.97), channel means within 3% (measured
  at most 1.5%: four pixels of 256 part, as tests/test_torch_render.py's
  goldens do); checkpoints load both ways (and into both packages'
  single-device ``Renderer``), and a spp resumed on both sides agrees on
  0.992 of pixels (floor 0.97).

The JAX steps are built once in module-scoped fixtures (a render step and
an adaptive step, about 20 s of XLA compiles each); the file takes about
100 s on an 8-core CPU.
"""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.assets.luts import load_spectral_luts as jax_luts
from digital_earth_tpu.assets.procgen import generate_earth_textures
from digital_earth_tpu.assets.textures import build_atlas as jax_build_atlas
from digital_earth_tpu.ops import spectral as jsp
from digital_earth_tpu.parallel import mesh as jmesh
from digital_earth_tpu.render import params as jparams
from digital_earth_tpu.render import renderer as jrend
from digital_earth_tpu_torch.app.viewer import EarthViewer
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.parallel import mesh
from digital_earth_tpu_torch.parallel.mesh import MultiChipRenderer, make_render_mesh
from digital_earth_tpu_torch.render import adaptive, raygen
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render.params import TraceConfig
from digital_earth_tpu_torch.render.renderer import Renderer
from test_torch_adaptive import _seeded_buffers
from test_torch_viewer import APOLLO, _serve, _stop

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

CFG = dict(max_bounces=4, land_march_steps=64, max_tracking_steps=512)
POS, LOOK, FOV = (35963490.0, 12765367.0, -42445899.0), (23201393.0, 8394073.0, -26074562.0), 0.127
CPU = torch.device("cpu")


def T(a):
    return torch.from_numpy(np.array(a))


def _pose(r):
    r.set_camera_pos(*POS)
    r.set_look_at(*LOOK)
    r.set_fov(FOV)
    return r


@pytest.fixture(scope="module")
def atlases():
    raw = generate_earth_textures((128, 256), seed=3)
    return jax_build_atlas(raw), build_atlas(raw, "cpu")


def _mesh(atlases, n_px, n_spp=1, res=(32, 8), tile_pixels=32, seed=5, options=None):
    m = make_render_mesh([CPU] * (n_px * n_spp), spp_axis=n_spp)
    return _pose(MultiChipRenderer(m, res, atlas=atlases[1],
                                   cfg=TraceConfig(**CFG, **(options or {})),
                                   tile_pixels=tile_pixels, seed=seed))


def _single(atlases, res=(32, 8), tile_pixels=32, seed=5, options=None):
    return _pose(Renderer("cpu", res, atlas=atlases[1], cfg=TraceConfig(**CFG, **(options or {})),
                          tile_pixels=tile_pixels, seed=seed))


# --- the mesh and its block ----------------------------------------------------


@pytest.mark.parametrize("w,h,tile_pixels,n_px", [
    (32, 8, 32, 4), (32, 8, 8, 4), (16, 8, 32, 2), (1920, 1080, 2048, 4),
    (1920, 1080, 2048, 3), (48, 27, 1296, 4), (30, 14, 64, 7),
])
def test_pick_sharded_block_matches_jax(w, h, tile_pixels, n_px):
    got = mesh._pick_sharded_block(w, h, tile_pixels, n_px)
    assert got == jmesh._pick_sharded_block(w, h, tile_pixels, n_px)
    assert ((w // got[0]) * (h // got[1])) % n_px == 0


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)), (4, (2, 2)),
                                     (8, (4, 2))])
def test_default_mesh_shape(n, shape):
    """The reference's default: 2 "spp" devices when the count is even and
    above 1 (tests/test_parallel.py:32-34 on 8 devices gives (4, 2))."""
    m = make_render_mesh([CPU] * n)
    assert (m.shape["px"], m.shape["spp"]) == shape
    assert m.distinct == [CPU]


def test_default_mesh_uses_cuda_cards_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_render_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = make_render_mesh()
    assert m.devices == ((torch.device("cuda:0"), torch.device("cuda:1")),
                         (torch.device("cuda:2"), torch.device("cuda:3")))
    with pytest.raises(ValueError):
        make_render_mesh([CPU] * 3, spp_axis=2)


# --- uniform steps ---------------------------------------------------------------


def test_mesh_matches_renderer_bit_for_bit(atlases):
    """(4, 1) over 2 spp at 16x8: each shard deposits every lane with one add
    into its own pixel, keyed by the global pixel id."""
    r, s = _mesh(atlases, 4, res=(16, 8)), _single(atlases, res=(16, 8))
    assert r.block == s.block and r.tiles_per_dev == 1
    for _ in range(2):
        r.accumulate()
        s.accumulate()
    assert (r.current_spp, r._rng_round, r.total_samples) == (2, 2, 256)
    assert r.color_buffer.any() and torch.equal(r.color_buffer, s.color_buffer)


def test_mesh_matches_renderer_at_32x8(atlases):
    r, s = _mesh(atlases, 4), _single(atlases)
    for _ in range(2):
        r.accumulate()
        s.accumulate()
    a, b = r.color_buffer, s.color_buffer
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert (a == b).all(-1).float().mean().item() >= 0.99


@pytest.mark.parametrize("options", [
    dict(hero_lambdas=1), dict(stratify_spp=False), dict(analytic_transmittance=False),
    dict(hero_lambdas=1, stratify_spp=False, analytic_transmittance=False),
])
def test_entry_points_render_the_reference_estimator(atlases, options):
    """Each of the reference estimator's options, and all three: a (4, 1)
    mesh bit-equal to the Renderer over a spp at 16x8, the Renderer's
    interruptible spp bit-equal to a whole one, an adaptive pass on the
    mesh adding whole tiles; the frame differs from the default config's."""
    r, s = _mesh(atlases, 4, res=(16, 8), options=options), _single(atlases, (16, 8),
                                                                     options=options)
    r.accumulate()
    s.accumulate()
    assert s.color_buffer.any() and torch.equal(r.color_buffer, s.color_buffer)
    c = _single(atlases, (16, 8), options=options)
    assert c.accumulate_interruptible(3)
    assert torch.equal(c.color_buffer, s.color_buffer)
    default = _single(atlases, (16, 8))
    default.accumulate()
    assert not torch.equal(default.color_buffer, s.color_buffer)
    a = _mesh(atlases, 4, tile_pixels=8, options=options)
    for _ in range(3):
        assert a.accumulate_adaptive(frac=0.5)
    assert a.mean_spp == pytest.approx(2.5)
    assert torch.isfinite(a.fetch_image()).all()


def test_spp_axis_matches_sequential_steps(atlases):
    r22, r41 = _mesh(atlases, 2, 2), _mesh(atlases, 4)
    r22.accumulate()  # spp 0 and 1 in one step
    r41.accumulate()
    r41.accumulate()
    assert r22.spp_per_step == 2 and r22.current_spp == r41.current_spp == 2
    assert r22.total_samples == r41.total_samples == 2 * 256
    torch.testing.assert_close(r22.color_buffer, r41.color_buffer, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_spp", [1, 2])
def test_chunked_step_matches_whole_and_abort_keeps_state(atlases, n_spp):
    a = _mesh(atlases, 4 // n_spp, n_spp, tile_pixels=8)
    b = _mesh(atlases, 4 // n_spp, n_spp, tile_pixels=8)
    assert a.tiles_per_dev == 8 * n_spp
    a.accumulate()
    polls = []
    assert b.accumulate_interruptible(4, interrupt=lambda: polls.append(1) and False)
    assert len(polls) >= 3  # 3 between chunks, the rest between bounces
    assert torch.equal(a.color_buffer, b.color_buffer)
    assert (b.current_spp, b.total_samples) == (n_spp, 256 * n_spp)
    before = b.color_buffer
    calls = []
    assert not b.accumulate_interruptible(4, interrupt=lambda: calls.append(1) or len(calls) == 2)
    assert (b.current_spp, b._rng_round, b.total_samples) == (n_spp, n_spp, 256 * n_spp)
    assert torch.equal(b.color_buffer, before)
    assert b.accumulate_interruptible(1)
    assert b.current_spp == 2 * n_spp


def test_worker_failure_fails_the_step(atlases, monkeypatch):
    """One shard's failure reaches the caller; with an interrupt the step is
    staged, so nothing of it lands."""
    r = _mesh(atlases, 4, tile_pixels=8)
    trace = mesh.trace_lanes
    started = []

    def failing(base_key, spp, lane0, n, *args, **kwargs):
        started.append(threading.current_thread().name)
        if lane0 == 2 * r.n_shard:
            raise RuntimeError("shard 2 failed")
        return trace(base_key, spp, lane0, n, *args, **kwargs)

    monkeypatch.setattr(mesh, "trace_lanes", failing)
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        r.accumulate_interruptible(1, interrupt=lambda: False)
    assert started and all(name.startswith("mesh-cpu") for name in started)
    assert not r.color_buffer.any() and (r.current_spp, r.total_samples) == (0, 0)


def test_workers_share_counters_and_poll_safely():
    """Many worker threads at a short switch interval: no launch count is
    lost (kernels._count's lock), and the step's interrupt poll calls the
    caller's ``interrupt()`` one thread at a time and stops everyone at its
    first True."""
    import sys

    from digital_earth_tpu_torch import kernels

    fn = kernels.select_tiles_shard
    inside, calls = [], []

    def interrupt():
        assert not inside, "interrupt() entered by two threads at once"
        inside.append(1)
        calls.append(1)
        time.sleep(0)
        inside.pop()
        return len(calls) == 50

    poll = mesh._Poll(interrupt)
    before = fn.launches

    def work():
        for _ in range(2000):
            kernels._count(fn, 1)
            poll()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches - before == 16 * 2000
    assert len(calls) == 50 and poll()


# --- adaptive passes ---------------------------------------------------------------


def test_adaptive_passes(atlases):
    """(tests/test_parallel.py:223-248) Uniform warm-up; then each device
    refines exactly k_local = int(tiles_per_dev * frac) of its own tiles; a
    frac=1 pass (and accumulate()) samples every pixel."""
    r = _mesh(atlases, 4, tile_pixels=8)
    tpd, tile = r.tiles_per_dev, r.tile
    assert tpd == 8
    for _ in range(2):
        assert r.accumulate_adaptive(frac=0.5)
    assert (r.count_buffer == 2.0).all() and r.current_spp == 2
    assert r.accumulate_adaptive(frac=0.5)
    per_tile = torch.stack(r._count).view(4, tpd, tile)
    assert (per_tile == per_tile[..., :1]).all()  # whole tiles
    assert ((per_tile[..., 0] == 3.0).sum(1) == 4).all()  # k_local = 4 per device
    assert r.mean_spp == pytest.approx(2.5) and r.current_spp == 2
    img = r.fetch_image()
    assert img.shape == (32, 8, 3) and torch.isfinite(img).all() and (img > 0).any()
    r.accumulate()
    c = r.count_buffer
    assert (c.min().item(), c.max().item()) == (3.0, 4.0)
    with pytest.raises(ValueError, match="adaptive"):
        r.accumulate_interruptible(2)


def test_adaptive_pass_abort_keeps_state(atlases):
    r = _mesh(atlases, 2, 2, tile_pixels=8)
    for _ in range(3):
        r.accumulate_adaptive(frac=0.25)
    before = [b.clone() for b in (r.color_buffer, r.count_buffer, r.lum2_buffer)]
    counters = (r.current_spp, r._rng_round, r._adaptive_rounds, r.total_samples)
    assert not r.accumulate_adaptive(frac=0.25, interrupt=lambda: True)
    assert counters == (r.current_spp, r._rng_round, r._adaptive_rounds, r.total_samples)
    for a, b in zip(before, (r.color_buffer, r.count_buffer, r.lum2_buffer)):
        assert torch.equal(a, b)
    # lum2 adds each spp's squared luminance, count the spp devices
    assert r.accumulate_adaptive(frac=0.25)
    assert (r.count_buffer - before[1]).unique().tolist() == [0.0, 2.0]


def _tile_major(a, block):
    w, h = a.shape[:2]
    bw, bh = block
    return np.ascontiguousarray(a.reshape(w // bw, bw, h // bh, bh, *a.shape[2:])
                                .swapaxes(1, 2).reshape(w * h, *a.shape[2:]))


def _jax_shard_ids(color, count, lum2, tile, k, m_bar):
    """The reference's shard scoring and top-k (mesh.py:190-199) on one
    shard, with the frame mean given."""
    n = jnp.maximum(count, 1.0)
    mean_lum = jsp.lum(color) / n
    var_mean = jnp.maximum(lum2 / n - mean_lum**2, 0.0) / n
    anchor = 0.2 * m_bar + 1e-20
    explore = (0.2 * m_bar) ** 2 / n**2
    score = (var_mean + explore) / (mean_lum + anchor) ** 2
    score = jnp.where(count < 1.0, jnp.inf, score)
    return np.asarray(jax.lax.top_k(score.reshape(-1, tile).mean(axis=1), k)[1])


@pytest.mark.parametrize("case", ["seeded", "nan_color", "nan_lum2"])
def test_shard_selection_matches_top_k(case):
    """``select_tiles_shard_plain`` on a shard with +inf, tied and all-zero
    tiles (and a NaN): lax.top_k's ids in order; ``shard_mean_plain`` within
    an ulp-level 1e-6 of the reference's jnp.mean."""
    w, h = 64, 36
    block = raygen.pick_block_dims(w, h, 96)
    color, count, lum2 = _seeded_buffers(w, h, block, seed=11)
    if case == "nan_color":
        color[40, 30, 0] = np.nan
    elif case == "nan_lum2":
        lum2[20, 3] = np.nan
    c, n, l2 = (_tile_major(a, block) for a in (color, count, lum2))
    tile = block[0] * block[1]
    n_tiles = c.shape[0] // tile
    mean = adaptive.shard_mean_plain(T(c), T(n))
    want_mean = np.mean(np.asarray(jsp.lum(jnp.asarray(c)) / np.maximum(n, 1.0)))
    np.testing.assert_allclose(mean.numpy(), [want_mean], rtol=1e-6)
    m_bar = mean * 1.25  # as if the other shards were brighter
    for k in (1, n_tiles // 4, n_tiles):
        got = adaptive.select_tiles_shard_plain(T(c), T(n), T(l2), tile, k, m_bar)
        assert got.dtype == torch.int32 and len(set(got.tolist())) == k
        want = _jax_shard_ids(jnp.asarray(c), jnp.asarray(n), jnp.asarray(l2), tile, k,
                              jnp.float32(m_bar.item()))
        np.testing.assert_array_equal(got.numpy(), want)


# --- against the JAX package's mesh --------------------------------------------------


@pytest.fixture(scope="module")
def jax_side(atlases):
    """The JAX MultiChipRenderer on 4 of the 8 CPU devices at 32x8 (its
    render step compiled once) after one spp, and its checkpoint."""
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs the 8-device CPU test mesh")
    jr = _pose(jmesh.MultiChipRenderer(jmesh.make_render_mesh(devs[:4], spp_axis=1), (32, 8),
                                       atlases[0], jax_luts(), cfg=jparams.TraceConfig(**CFG),
                                       tile_pixels=32, seed=5))
    jr.accumulate()
    return jr, jr.fetch_buffer()


def test_mesh_frame_matches_jax_multichip(atlases, jax_side):
    jr, want = jax_side
    r = _mesh(atlases, 4)
    assert r.block == tuple(jr.block) and r.tiles_per_dev == jr.tiles_per_dev
    r.accumulate()
    got = r.fetch_buffer()
    assert np.isfinite(got).all() and got.any()
    share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= 0.97, share
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.03)


def test_checkpoints_load_both_ways_with_jax_multichip(atlases, jax_side, tmp_path):
    jr, spp1 = jax_side
    p = str(tmp_path / "jax.npz")
    jr.save_checkpoint(p)
    r = _mesh(atlases, 2, 2, seed=99)
    r.load_checkpoint(p)  # JAX (4, 1) -> port (2, 2)
    assert (r.current_spp, r._rng_round, r.total_samples, r._seed_key) == (1, 1, 256, (0, 5))
    np.testing.assert_array_equal(r.fetch_buffer(), spp1)
    r.accumulate()  # spp 1 and 2
    q = str(tmp_path / "port.npz")
    r.save_checkpoint(q)
    # the single-device renderers of both packages read it too
    single, jsingle = _single(atlases), jrend.Renderer(image_res=(32, 8), atlas=atlases[0],
                                                      tile_pixels=32)
    single.load_checkpoint(q)
    jsingle.load_checkpoint(q)
    np.testing.assert_array_equal(single.color_buffer.numpy(), r.fetch_buffer())
    np.testing.assert_array_equal(np.asarray(jsingle.color_buffer), r.fetch_buffer())
    assert single.current_spp == jsingle.current_spp == 3
    jr.load_checkpoint(q)  # port -> JAX
    try:
        assert jr.current_spp == 3
        np.testing.assert_array_equal(jr.fetch_buffer(), r.fetch_buffer())
        r4 = _mesh(atlases, 4)
        r4.load_checkpoint(q)
        jr.accumulate()  # spp 3 on both sides, resumed
        r4.accumulate()
        share = np.isclose(r4.fetch_buffer(), jr.fetch_buffer(), rtol=1e-3,
                           atol=1e-7).all(-1).mean()
        assert share >= 0.97, share
        # with adaptive counts
        a = _mesh(atlases, 4, seed=3)
        for _ in range(3):
            a.accumulate_adaptive(frac=0.5)
        a.save_checkpoint(q)
        jr.load_checkpoint(q)
        np.testing.assert_array_equal(np.asarray(jr._assemble(jr.count_buffer)),
                                      a.count_buffer.numpy())
        np.testing.assert_array_equal(np.asarray(jr._assemble(jr.lum2_buffer)),
                                      a.lum2_buffer.numpy())
        assert (jr._rng_round, jr._adaptive_rounds, jr.total_samples) == (3, 3, a.total_samples)
    finally:
        jr.load_checkpoint(p)
    b = _mesh(atlases, 4)
    b.load_checkpoint(q)  # adaptive port -> port
    assert torch.equal(b.count_buffer, a.count_buffer) and b.mean_spp == a.mean_spp


def test_adaptive_selection_matches_jax_step(atlases):
    """One non-uniform pass of the JAX ``make_sharded_adaptive_step`` and of
    the port on the same seeded buffers: every device's tiles scored well
    apart (one relative-variance level per tile, 1.3x from one to the
    next), so both refine the same pixels."""
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs the 8-device CPU test mesh")
    w, h = 32, 8
    r = _mesh(atlases, 4, tile_pixels=8)
    block, tpd, tile = r.block, r.tiles_per_dev, r.tile
    assert block == jmesh._pick_sharded_block(w, h, 8, 4)
    k_local = max(1, int(tpd * 0.25))
    nby = h // block[1]
    tid = (np.arange(w)[:, None] // block[0]) * nby + np.arange(h)[None, :] // block[1]
    levels = 1.3 ** np.random.default_rng(4).permutation(tid.max() + 1)
    count = np.full((w, h), 2.0, np.float32)
    color = np.full((w, h, 3), 1.0, np.float32)  # mean luminance 0.5 everywhere
    lum2 = (count * 0.25 * (1.0 + levels[tid])).astype(np.float32)
    r.color_buffer, r.count_buffer, r.lum2_buffer = T(color), T(count), T(lum2)
    r.current_spp, r._rng_round, r._adaptive_rounds = 2, 7, 2
    assert r.accumulate_adaptive(frac=0.25)
    got = torch.cat(r._count).numpy()

    jm = jmesh.make_render_mesh(devs[:4], spp_axis=1)
    step = jmesh.make_sharded_adaptive_step(jm, (w, h), jparams.TraceConfig(**CFG), block,
                                            k_local)
    jr = _pose(jrend.Renderer(image_res=(w, h), atlas=atlases[0], tile_pixels=8, seed=5))
    flat = [jnp.asarray(_tile_major(a, block)) for a in (color, count, lum2)]
    _, jcount, _ = step(jax.random.PRNGKey(5), jnp.int32(7), *flat, jr._camera_params(),
                        jr._scene_params(), atlases[0], jax_luts(), jnp.asarray(False))
    want = np.asarray(jcount)
    assert ((got == 3.0).reshape(4, -1).sum(1) == k_local * tile).all()
    np.testing.assert_array_equal(got, want)
    # the same tiles as the shard twin's, device by device
    for px in range(4):
        ids = adaptive.select_tiles_shard_plain(
            T(_tile_major(color, block)[px * r.n_shard:(px + 1) * r.n_shard]),
            T(_tile_major(count, block)[px * r.n_shard:(px + 1) * r.n_shard]),
            T(_tile_major(lum2, block)[px * r.n_shard:(px + 1) * r.n_shard]),
            tile, k_local, torch.tensor([0.5]))
        refined = np.flatnonzero(want[px * r.n_shard:(px + 1) * r.n_shard:tile] == 3.0)
        assert sorted(ids.tolist()) == refined.tolist()


# --- the viewer over a mesh ------------------------------------------------------------


def test_viewer_over_a_mesh(atlases, tmp_path):
    """EarthViewer drives a (2, 1) MultiChipRenderer unchanged: a preview
    frame, then adaptive path passes, a full-size PNG."""
    config = tmp_path / "config.txt"
    config.write_text(open(APOLLO).read())
    m = make_render_mesh([CPU] * 2, spp_axis=1)
    r = MultiChipRenderer(m, (16, 8), atlas=atlases[1], tile_pixels=16,
                          cfg=TraceConfig(max_bounces=3, land_march_steps=64,
                                          max_tracking_steps=256))
    v = EarthViewer(renderer=r, config_path=str(config), screenshot_dir=str(tmp_path / "shots"),
                    port=0, adaptive_frac=0.25)
    assert v.preview_renderer.device == CPU
    loop, server = _serve(v)
    try:
        url = f"http://127.0.0.1:{v._test_port}"
        deadline, s = time.time() + 120, None
        while time.time() < deadline:
            s = json.loads(urllib.request.urlopen(url + "/state", timeout=30).read())
            if s["frame_source"] == "path" and s["spp"] > 2:
                break
        assert s["error"] is None and s["spp"] > 2 and s["spp"] != int(s["spp"]), s
        png = urllib.request.urlopen(url + "/frame.png", timeout=30).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and png[16:24] == bytes([0, 0, 0, 16, 0, 0, 0, 8])
    finally:
        _stop(v, loop, server)
    assert r._adaptive_rounds >= 3 and r.count_buffer.min().item() >= 2
