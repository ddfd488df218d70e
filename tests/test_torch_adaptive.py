"""Adaptive tile sampling in the PyTorch port against the JAX package, on
the CPU, with inputs made from a numpy seed:

- ``select_tiles_plain`` against the reference's ``_select_tiles`` on seeded
  buffers at three sizes, with never-sampled tiles, exact ties and an
  all-zero tile: the same tile ids in the same order. Both sum the scores
  in their own fixed order, so a score may differ by an ulp; the seeded
  scores have no two tiles within 1e-5 of each other except the exact ties,
  which both order by tile id; with an infinite or NaN buffer value, NaN
  scores rank in XLA's total order as ``lax.top_k`` ranks them;
- ``frame_end_plain`` against ``shade_primary_miss`` -> ``finalize_radiance``
  -> einsum -> ``xyz_to_rgb`` -> ``.at[pu, pv].add`` on one seeded state with
  primary misses, sun-disk hits and NaN, infinite and negative lanes
  (stated tolerance 1e-6 relative, with an absolute floor of 1e-6 of the
  largest value for channels that cancel in ``xyz_to_rgb``; measured: 74%
  of the values bit-equal, every one within 1.5e-7 of the largest, the
  worst relative error 3.3e-4 on a channel that cancels), and in preview
  mode;
- ray generation from a tile list against the reference's ``gen_rays``
  under ``tile_ids`` (keys bit-equal, directions and wavelengths within the
  gates of tests/test_torch_kernels_cuda.py);
- the contracts of tests/test_adaptive.py, ported;
- adaptive checkpoints written by either renderer and resumed by the other,
  and whole adaptive runs of both renderers side by side.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.assets import luts as jluts
from digital_earth_tpu.assets.procgen import generate_earth_textures
from digital_earth_tpu.assets.textures import build_atlas as jax_build_atlas
from digital_earth_tpu.ops import spectral as jsp
from digital_earth_tpu.render import params as jparams
from digital_earth_tpu.render import pathtracer as jpt
from digital_earth_tpu.render import renderer as jrend
from digital_earth_tpu_torch.app.config_io import load_config
from digital_earth_tpu_torch.assets import luts as tluts
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.render import adaptive, film, raygen
from digital_earth_tpu_torch.render import frame_end as fe
from digital_earth_tpu_torch.render import pathtracer as pt
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
RES, TILE_PIXELS = (32, 18), 48
# the pose of tests/test_adaptive.py: the planet and black space in one frame
POSE = dict(pos=(35963490.23, 12765367.04, -42445899.30),
            look_at=(23201393.60, 8394073.28, -26074562.14),
            up=(0.26080362, 0.67502094, -0.69016534), fov=0.12692034,
            sun_angle=5.08136888, sun_path_rot=-1.70960241)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def atlases():
    raw = generate_earth_textures((64, 128), seed=3)
    return jax_build_atlas(raw), build_atlas(raw, "cpu")


def _pose(r):
    r.set_camera_pos(*POSE["pos"])
    r.set_look_at(*POSE["look_at"])
    r.set_up(*POSE["up"])
    r.set_fov(POSE["fov"])
    r.set_sun_angle(POSE["sun_angle"])
    r.set_sun_path_rot(POSE["sun_path_rot"])
    return r


def _port(atlases, seed=0, res=RES):
    return _pose(Renderer("cpu", image_res=res, atlas=atlases[1], tile_pixels=TILE_PIXELS,
                          seed=seed, cfg=TraceConfig(**SMALL)))


def _jax(atlases, seed=0, res=RES):
    return _pose(jrend.Renderer(image_res=res, atlas=atlases[0], tile_pixels=TILE_PIXELS,
                                seed=seed, cfg=jparams.TraceConfig(**SMALL)))


def _k(r, frac=0.25):
    w, h = r.image_res
    n_tiles = (w // r.block[0]) * (h // r.block[1])
    return n_tiles, max(1, int(n_tiles * frac))


# --- tile selection ------------------------------------------------------------


def _seeded_buffers(w, h, block, seed):
    """Colour sums, counts and sums of squared luminance of n samples per
    pixel, with never-sampled tiles, a copy of one tile onto another (an
    exact tie) and an all-zero tile."""
    r = np.random.default_rng(seed)
    n = r.integers(1, 7, (w, h)).astype(np.float32)
    mean = np.exp(r.normal(-1.0, 1.5, (w, h, 3))).astype(np.float32)
    mean *= (r.random((w, h, 1)) < 0.9)  # some black pixels
    lum = mean @ jsp.LUM_WEIGHTS
    lum2 = n * (lum * lum + np.exp(r.normal(-3.0, 2.0, (w, h))) * lum * lum)
    color = mean * n[..., None]
    bw, bh = block

    def tile(t):
        nby = h // bh
        bx, by = divmod(t, nby)
        return slice(bx * bw, (bx + 1) * bw), slice(by * bh, (by + 1) * bh)

    n_tiles = (w // bw) * (h // bh)
    for t in (1, n_tiles - 2):  # never sampled: +inf, tied
        n[tile(t)] = 0.0
        color[tile(t)] = 0.0
        lum2[tile(t)] = 0.0
    n[tile(3)] = 0.0  # one pixel column never sampled ...
    n[tile(3)][1:] = 2.0  # ... the rest sampled: the tile still scores +inf
    for arr in (n, color, lum2):
        arr[tile(5)] = arr[tile(2)]  # an exact tie at a finite score
    color[tile(4)] = 0.0  # all zero, but sampled
    lum2[tile(4)] = 0.0
    return color.astype(np.float32), n.astype(np.float32), lum2.astype(np.float32)


@pytest.mark.parametrize("w,h,tile_pixels", [(32, 18, 48), (64, 36, 96), (160, 90, 400)])
def test_select_tiles_matches_jax(w, h, tile_pixels):
    block = raygen.pick_block_dims(w, h, tile_pixels)
    assert block == jrend._pick_block_dims(w, h, tile_pixels)
    color, count, lum2 = _seeded_buffers(w, h, block, seed=w)
    n_tiles = (w // block[0]) * (h // block[1])
    scores = adaptive.tile_scores_plain(T(color), T(count), T(lum2), block).numpy()
    assert np.isinf(scores[[1, 3, n_tiles - 2]]).all() and scores[5] == scores[2]
    finite = np.sort(scores[np.isfinite(scores)])
    gaps = np.diff(finite) / finite[1:]
    assert (gaps[gaps > 0] > 1e-5).all()  # no near-tie for an ulp to flip
    for k in (1, max(1, n_tiles // 4), n_tiles):
        got = adaptive.select_tiles_plain(T(color), T(count), T(lum2), block, k)
        want = np.asarray(jrend._select_tiles(jnp.asarray(color), jnp.asarray(count),
                                              jnp.asarray(lum2), (w, h), block, k))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    order = adaptive.select_tiles_plain(T(color), T(count), T(lum2), block, n_tiles).tolist()
    assert order[:3] == [1, 3, n_tiles - 2]  # +inf first, ties by id
    assert order.index(2) == order.index(5) - 1


@pytest.mark.parametrize("case", ["inf_color", "neg_inf_color", "nan_color", "nan_lum2"])
def test_select_tiles_orders_nan_scores_as_top_k(case):
    """A non-finite buffer value makes NaN scores (one tile's, or every
    tile's through the frame mean); the ids stay k distinct tiles in range,
    in lax.top_k's total order, where +NaN ranks first and -NaN last."""
    w, h = 64, 36
    block = raygen.pick_block_dims(w, h, 96)
    n_tiles = (w // block[0]) * (h // block[1])
    color, count, lum2 = _seeded_buffers(w, h, block, seed=7)
    if case == "inf_color":
        color[10, 7, 1] = np.inf
    elif case == "neg_inf_color":
        color[40, 30, 2] = -np.inf
    elif case == "nan_color":
        color[40, 30, 0] = np.nan
    else:
        lum2[20, 3] = np.nan
    scores = adaptive.tile_scores_plain(T(color), T(count), T(lum2), block)
    assert torch.isnan(scores).any()
    for k in (1, n_tiles // 4, n_tiles):
        got = adaptive.select_tiles_plain(T(color), T(count), T(lum2), block, k).numpy()
        assert len(set(got.tolist())) == k and 0 <= got.min() and got.max() < n_tiles
        want = np.asarray(jrend._select_tiles(jnp.asarray(color), jnp.asarray(count),
                                              jnp.asarray(lum2), (w, h), block, k))
        np.testing.assert_array_equal(got, want)


def _kernel_rank(scores):
    """The select_tiles kernel's rank recipe (csrc/select_tiles.cu launch B),
    as a plain function: 64-bit keys ~(order_key ^ 2^31) << 32 | tile,
    sorted ascending."""
    ok = adaptive.order_keys(scores).numpy().astype(np.int64)
    biased = (ok + 2**31).astype(np.uint64)  # the signed key as an unsigned one
    keys = ((np.uint64(0xFFFFFFFF) - biased) << np.uint64(32)) | np.arange(len(ok), dtype=np.uint64)
    return (np.sort(keys) & np.uint64(0xFFFFFFFF)).astype(np.int32)


@pytest.mark.parametrize("case", ["ties", "inf_color", "neg_inf_color", "nan_lum2",
                                  "nan_everywhere"])
def test_kernel_rank_keys_give_the_twins_order(case):
    """Sorting the kernel's keys ranks the tiles as the twin's stable
    descending sort of the total-order keys does: ties to the lower id,
    +inf, +NaN and -NaN where lax.top_k puts them."""
    w, h = 64, 36
    block = raygen.pick_block_dims(w, h, 96)
    n_tiles = (w // block[0]) * (h // block[1])
    color, count, lum2 = _seeded_buffers(w, h, block, seed=11)
    if case == "inf_color":
        color[10, 7, 1] = np.inf
    elif case == "neg_inf_color":
        color[40, 30, 2] = -np.inf
    elif case == "nan_lum2":
        lum2[20, 3] = np.nan
    elif case == "nan_everywhere":
        lum2[::7, ::5] = np.nan
        lum2[1::9, ::4] = -np.nan
    scores = adaptive.tile_scores_plain(T(color), T(count), T(lum2), block)
    got = _kernel_rank(scores)
    want = adaptive.select_tiles_plain(T(color), T(count), T(lum2), block, n_tiles).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n_tiles))


# Past the sizes the select_tiles kernel once refused (more than 8192 tiles,
# a tile of more than 8192 pixels, more than 1024 x 8192 pixels). Stated
# tolerance: the ids equal to the reference's in order; m_bar within rtol
# 1e-6 of jnp.mean and every tile score within rtol 1e-4 of the reference's
# (each sums in its own order; XLA's CPU reduce over a 1920-pixel tile
# parts by up to 1.2e-5). The buffers keep every two finite tile scores at
# least 1e-3 apart but for the exact tie, so that neither order can swap
# them.


def _separated_buffers(w, h, block, seed):
    """Two samples per pixel, every pixel's mean luminance about 0.5 and its
    variance g_t of its tile t, g on a geometric grid of ratio 1.002 in a
    seeded order (lum2 jittered by 1e-6 per pixel, so the tile sums' order
    matters to the last bits); two never-sampled tiles (+inf, tied) and
    tile 2 copied onto tile 5 (an exact tie)."""
    r = np.random.default_rng(seed)
    bw, bh = block
    nby = h // bh
    n_tiles = (w // bw) * nby
    g = 0.05 * 1.002 ** r.permutation(n_tiles)
    tile = (np.arange(w)[:, None] // bw) * nby + np.arange(h)[None, :] // bh
    count = np.full((w, h), 2.0, np.float32)
    color = np.full((w, h, 3), 1.0, np.float32)
    lum = color[0, 0] @ jsp.LUM_WEIGHTS / 2.0
    lum2 = (2.0 * (lum * lum + 2.0 * g[tile]) * (1.0 + 1e-6 * r.standard_normal((w, h))))
    lum2 = lum2.astype(np.float32)
    if n_tiles > 5:
        lum2[tile == 5] = lum2[tile == 2]
    for t in (1, n_tiles - 1):
        count[tile == t] = 0.0
    return color, count, lum2


def _reference_tile_scores(color, count, lum2, block):
    """The reference's tile scores (renderer.py:439-464) in jnp."""
    w, h = count.shape
    bw, bh = block
    n = jnp.maximum(count, 1.0)
    mean_lum = jsp.lum(color) / n
    var_mean = jnp.maximum(lum2 / n - mean_lum**2, 0.0) / n
    m_bar = jnp.mean(mean_lum)
    explore = (0.2 * m_bar) ** 2 / n**2
    score = (var_mean + explore) / (mean_lum + 0.2 * m_bar + 1e-20) ** 2
    score = jnp.where(count < 1.0, jnp.inf, score)
    return m_bar, score.reshape(w // bw, bw, h // bh, bh).mean(axis=(1, 3)).reshape(-1)


@pytest.mark.parametrize("w,h,tile_pixels,n_tiles", [
    (1024, 576, 64, 9216),      # more than 8192 tiles
    (128, 72, 1, 9216),         # more than 8192 tiles of one pixel
    (512, 288, 16, 9216),       # more than 8192 tiles of 4x4
    (256, 128, 16384, 2),       # tiles of 16384 pixels
    (4096, 2160, 2048, 4608),   # more than 1024 x 8192 pixels
])
def test_select_tiles_past_the_old_caps_matches_jax(w, h, tile_pixels, n_tiles):
    block = raygen.pick_block_dims(w, h, tile_pixels)
    assert (w // block[0]) * (h // block[1]) == n_tiles
    color, count, lum2 = _separated_buffers(w, h, block, seed=n_tiles)
    m_want, s_want = _reference_tile_scores(*(jnp.asarray(a) for a in (color, count, lum2)),
                                            block)
    m_bar = adaptive.shard_mean_plain(T(color).reshape(-1, 3), T(count).reshape(-1))
    np.testing.assert_allclose(m_bar.numpy(), [float(m_want)], rtol=1e-6)
    scores = adaptive.tile_scores_plain(T(color), T(count), T(lum2), block).numpy()
    np.testing.assert_allclose(scores, np.asarray(s_want), rtol=1e-4)
    finite = np.sort(scores[np.isfinite(scores)])
    gaps = np.diff(finite) / finite[1:]
    assert (gaps[gaps > 0] > 1e-3).all()
    for k in sorted({1, max(1, n_tiles // 4), n_tiles}):
        got = adaptive.select_tiles_plain(T(color), T(count), T(lum2), block, k)
        want = np.asarray(jrend._select_tiles(jnp.asarray(color), jnp.asarray(count),
                                              jnp.asarray(lum2), (w, h), block, k))
        np.testing.assert_array_equal(got.numpy(), want)


def test_shard_selection_past_the_old_caps_matches_top_k():
    """A shard of 9216 tiles (tile-major, 64 pixels each) against
    lax.top_k's ids, and the mean of a 4096x2160-pixel shard against
    jnp.mean (rtol 1e-6)."""
    import jax

    w, h, block = 1024, 576, (8, 8)
    color, count, lum2 = _separated_buffers(w, h, block, seed=3)
    tile = block[0] * block[1]

    def tile_major(a):
        return np.ascontiguousarray(a.reshape(w // 8, 8, h // 8, 8, *a.shape[2:])
                                    .swapaxes(1, 2).reshape(w * h, *a.shape[2:]))

    c, n, l2 = (tile_major(a) for a in (color, count, lum2))
    m_bar = adaptive.shard_mean_plain(T(c), T(n)) * 1.25
    mb = jnp.float32(m_bar.item())
    nj = jnp.maximum(jnp.asarray(n), 1.0)
    mean_lum = jsp.lum(jnp.asarray(c)) / nj
    var_mean = jnp.maximum(jnp.asarray(l2) / nj - mean_lum**2, 0.0) / nj
    score = (var_mean + (0.2 * mb) ** 2 / nj**2) / (mean_lum + 0.2 * mb + 1e-20) ** 2
    score = jnp.where(jnp.asarray(n) < 1.0, jnp.inf, score).reshape(-1, tile).mean(axis=1)
    for k in (1, 2304, 9216):
        got = adaptive.select_tiles_shard_plain(T(c), T(n), T(l2), tile, k, m_bar)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.lax.top_k(score, k)[1]))
    big = _separated_buffers(4096, 2160, (32, 60), seed=5)
    got = adaptive.shard_mean_plain(T(big[0]).reshape(-1, 3), T(big[1]).reshape(-1))
    want = jnp.mean(jsp.lum(jnp.asarray(big[0])) / jnp.maximum(jnp.asarray(big[1]), 1.0))
    np.testing.assert_allclose(got.numpy(), [float(want)], rtol=1e-6)


def test_tree_sum_is_the_halving_order():
    x = torch.from_numpy(np.random.default_rng(0).random((3, 13)).astype(np.float32))
    p = torch.nn.functional.pad(x, (0, 3))
    for h in (8, 4, 2, 1):
        p = p[:, :h] + p[:, h:2 * h]
    assert torch.equal(adaptive.tree_sum(x), p[:, 0])
    assert torch.equal(adaptive.tree_sum(x[:, :1]), x[:, 0])


# --- the frame's end -----------------------------------------------------------


@pytest.fixture(scope="module")
def end_state(atlases):
    """One seeded end-of-sweep state: 4096 lanes of 4 wavelengths, 40%
    primary misses (a tenth of them in the sun disk), some NaN, infinite and
    negative radiance, each lane on its own pixel of a 96x64 frame."""
    r = np.random.default_rng(11)
    n, L, w, h = 4096, 4, 96, 64
    cfg = load_config(APOLLO)
    jscene = jparams.make_scene_params(cfg.sun_angle, cfg.sun_path_rot, 7800.0)
    tscene = tparams.make_scene_params("cpu", cfg.sun_angle, cfg.sun_path_rot, 7800.0)
    light = np.asarray(jscene.light_direction)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = r.random(n) < 0.1
    d[sun] = light + r.normal(scale=2e-3, size=(sun.sum(), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    miss = r.random(n) < 0.4
    rad = np.exp(r.normal(-2.0, 2.0, (n, L)))
    rad[r.random((n, L)) < 0.02] = np.nan
    rad[r.random((n, L)) < 0.01] = np.inf
    rad[r.random((n, L)) < 0.02] *= -1.0
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    state = dict(
        direction=f32(d), wavelength=f32(r.uniform(390.0, 831.0, (n, L))),
        lambda_pdf=f32(r.uniform(0.0, 0.01, (n, L))), throughput=f32(r.uniform(0.0, 1.5, (n, L))),
        radiance=f32(rad), w_mis=f32(r.uniform(0.5, 2.0, (n, L))), primary_miss=miss,
    )
    responses = f32(r.uniform(0.0, 2.0, (n, L, 3)))
    pid = r.permutation(w * h)[:n]
    return dict(state=state, responses=responses, pid=pid, res=(w, h), scenes=(jscene, tscene),
                n_sun=int((miss & sun).sum()))


def _jax_frame_end(es, atlases):
    s = es["state"]
    n = s["radiance"].shape[0]
    st = jpt.TraceState(
        pos=jnp.zeros((n, 3)), direction=jnp.asarray(s["direction"]),
        wavelength=jnp.asarray(s["wavelength"]), lambda_pdf=jnp.asarray(s["lambda_pdf"]),
        throughput=jnp.asarray(s["throughput"]), radiance=jnp.asarray(s["radiance"]),
        w_mis=jnp.asarray(s["w_mis"]), alive=jnp.zeros((n,), bool),
        primary_miss=jnp.asarray(s["primary_miss"]), rng=jnp.zeros((n, 2), jnp.uint32),
        work_class=jnp.zeros((n,), jnp.int32),
    )
    st = jpt.shade_primary_miss(st, es["scenes"][0], atlases[0], jluts.load_spectral_luts(),
                                jparams.TraceConfig())
    radiance = jpt.finalize_radiance(st)
    rgb = jsp.xyz_to_rgb(jnp.einsum("nl,nlc->nc", radiance, jnp.asarray(es["responses"])))
    w, h = es["res"]
    pu, pv = es["pid"] // h, es["pid"] % h
    lum = jsp.lum(rgb)
    return (np.asarray(jnp.zeros((w, h, 3)).at[pu, pv].add(rgb)),
            np.asarray(jnp.zeros((w, h)).at[pu, pv].add(1.0)),
            np.asarray(jnp.zeros((w, h)).at[pu, pv].add(lum * lum)))


def _close(got, want, rtol=1e-6):
    atol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_frame_end_matches_jax(atlases, end_state):
    es = end_state
    s = {k: T(v) for k, v in es["state"].items()}
    w, h = es["res"]
    assert es["n_sun"] > 50
    n = len(es["pid"])
    st = pt.TraceState(pos=torch.zeros((n, 3)), alive=torch.zeros(n, dtype=torch.bool),
                       rng=torch.zeros((n, 2), dtype=torch.int64),
                       work_class=torch.zeros(n, dtype=torch.int32), **s)
    miss = fe.MissShading(st, es["scenes"][1], atlases[1], tluts.load_spectral_luts("cpu"),
                          TraceConfig())
    color = torch.zeros((w * h, 3))
    count, lum2 = torch.zeros(w * h), torch.zeros(w * h)
    pid = T(es["pid"])
    assert pid.unique().numel() == n  # one lane per pixel
    radiance = st.radiance.clone()
    fe.frame_end_plain(T(es["responses"]), pid, color, count, lum2, miss=miss)
    # the state is left as it was (NaN lanes included)
    assert torch.allclose(st.radiance, radiance, rtol=0, atol=0, equal_nan=True)
    want_c, want_n, want_l2 = _jax_frame_end(es, atlases)
    assert np.isfinite(color.numpy()).all()
    _close(color.view(w, h, 3).numpy(), want_c)
    np.testing.assert_array_equal(count.view(w, h).numpy(), want_n)
    _close(lum2.view(w, h).numpy(), want_l2)
    # the deposit adds: a second call doubles the buffer, counts go to 2
    fe.frame_end(T(es["responses"]), pid, color, count, lum2, miss=miss)
    _close(color.view(w, h, 3).numpy(), 2 * want_c)
    assert set(np.unique(count.numpy())) == {0.0, 2.0}


def test_frame_end_preview_matches_jax():
    r = np.random.default_rng(12)
    n, w, h = 1000, 40, 30
    rad = r.uniform(0.0, 5.0, n).astype(np.float32)
    resp = r.uniform(0.0, 2.0, (n, 1, 3)).astype(np.float32)
    rcp = r.uniform(0.0, 300.0, (n, 1)).astype(np.float32)
    pid = r.permutation(w * h)[:n]
    color = torch.zeros((w * h, 3))
    fe.frame_end_plain(T(resp), T(pid), color, radiance=T(rad)[:, None], pdf=T(rcp))
    rgb = jsp.xyz_to_rgb(jnp.asarray(rad)[:, None] * jnp.asarray(resp[:, 0]) * jnp.asarray(rcp))
    want = np.zeros((w * h, 3), np.float32)
    want[pid] = np.asarray(rgb)
    _close(color.numpy(), want)


# --- ray generation from a tile list -------------------------------------------


class _Captured(Exception):
    pass


def test_gen_rays_from_a_tile_list_matches_jax(atlases, monkeypatch):
    jr, tr = _jax(atlases), _port(atlases)
    w, h = RES
    block = tr.block
    assert block == jr.block
    n_tiles, _ = _k(tr)
    ids = np.array([n_tiles - 1, 0, 5, 2, 7], np.int32)
    tile = block[0] * block[1]
    # the tile map itself
    lane = torch.arange(len(ids) * tile)
    _, _, pu, pv = raygen.tile_pixel_coords(lane, RES, block, T(ids))
    jpu, jpv = jrend._tile_pixel_coords(jnp.asarray(ids), RES, block)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(jpu))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))
    assert (pu * h + pv).unique().numel() == lane.numel()  # distinct pixels
    # the reference's rays: its frame-wide ray generation (binned_stage1)
    # is the same per-lane function, run once over the tile list
    got_state = {}

    def capture(pos, dirs, wavelengths, lambda_pdf, rng_keys):
        got_state.update(dirs=dirs, wavelengths=wavelengths, pdf=lambda_pdf, keys=rng_keys)
        raise _Captured

    monkeypatch.setattr(jpt, "init_state", capture)
    cfg = jparams.TraceConfig(**SMALL, binned_stage1=True)
    with pytest.raises(_Captured):
        jrend._trace_tile_range(jr._base_key, 3, jr._camera_params(), jr._scene_params(),
                                jr.atlas, jr.luts, RES, block, cfg, 0, len(ids),
                                tile_ids=jnp.asarray(ids))
    rays = raygen.gen_rays_plain(tr._seed_key, 3, 0, len(ids) * tile, RES, block,
                                 tr.camera_params(), tr.luts, False, T(ids))
    np.testing.assert_array_equal(rays.keys.numpy(), np.asarray(got_state["keys"]).astype(np.int64))
    np.testing.assert_allclose(rays.dirs.numpy(), np.asarray(got_state["dirs"]), atol=1e-6)
    np.testing.assert_allclose(rays.wavelengths.numpy(), np.asarray(got_state["wavelengths"]),
                               rtol=1e-6)
    np.testing.assert_allclose(rays.pdf.numpy(), np.asarray(got_state["pdf"]), rtol=1e-4,
                               atol=1e-6)


# --- the contracts of tests/test_adaptive.py -----------------------------------


def test_uniform_pass_bit_identical_to_accumulate(atlases):
    a, b = _port(atlases, seed=7), _port(atlases, seed=7)
    for _ in range(2):
        a.accumulate()
        assert b.accumulate_adaptive(frac=1.0)
    assert torch.equal(a.color_buffer, b.color_buffer)
    assert b.current_spp == 2 and (b.count_buffer == 2.0).all()
    assert b.total_samples == a.total_samples == 2 * RES[0] * RES[1]
    np.testing.assert_allclose(a.fetch_image().numpy(), b.fetch_image().numpy(), rtol=0,
                               atol=1e-6)
    b.accumulate()  # routed through a uniform adaptive pass: counts stay right
    assert (b.count_buffer == 3.0).all() and b.current_spp == 3


def test_partial_pass_updates_only_selected(atlases):
    r = _port(atlases, seed=1)
    for _ in range(2):
        r.accumulate_adaptive(frac=1.0)
    counts0, color0 = r.count_buffer.clone(), r.color_buffer.clone()
    n_tiles, k = _k(r)
    ids = adaptive.select_tiles(r.color_buffer, r.count_buffer, r.lum2_buffer, r.block, k)
    assert r.accumulate_adaptive(frac=0.25, min_warmup=2)
    delta = (r.count_buffer - counts0).numpy()
    assert set(np.unique(delta)) <= {0.0, 1.0}
    assert delta.sum() == k * r.tile
    bw, bh = r.block
    nby = RES[1] // bh
    chosen = np.zeros(RES, bool)
    for t in ids.tolist():
        chosen[(t // nby) * bw:(t // nby + 1) * bw, (t % nby) * bh:(t % nby + 1) * bh] = True
    np.testing.assert_array_equal(delta == 1.0, chosen)
    assert torch.equal(r.color_buffer[~torch.from_numpy(chosen)], color0[~torch.from_numpy(chosen)])
    assert (r.current_spp, r._rng_round) == (2, 3)
    assert r.mean_spp == pytest.approx(r.total_samples / (RES[0] * RES[1]))


def test_selection_targets_high_variance_blocks(atlases):
    r = _port(atlases, seed=2)
    for _ in range(2):
        r.accumulate_adaptive(frac=1.0)
    for _ in range(6):
        r.accumulate_adaptive(frac=0.25, min_warmup=2)
    counts = r.count_buffer.numpy()
    lum = r.color_buffer.numpy().sum(-1)
    content = lum > np.percentile(lum, 80)
    space = lum <= np.percentile(lum, 20)
    assert counts[content].mean() > counts[space].mean()


def test_fetch_divides_by_per_pixel_counts(atlases):
    r = _port(atlases, seed=3)
    for _ in range(2):
        r.accumulate_adaptive(frac=1.0)
    for _ in range(3):
        r.accumulate_adaptive(frac=0.25, min_warmup=2)
    img = r.fetch_image().numpy()
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    counts = r.count_buffer.numpy()
    assert counts.min() >= 2.0 and counts.max() >= 3.0
    # the per-pixel mean feeding the film: sum / count
    mean = r.color_buffer / r.count_buffer[..., None]
    want = film.postprocess(mean * 4.0, 4.0, r.exposure, r.gamma, r.crf.curves, r.selected_crf)
    np.testing.assert_allclose(img, want.numpy(), atol=1e-5)


def test_adaptive_requires_reset(atlases):
    r = _port(atlases, seed=4)
    r.accumulate()
    with pytest.raises(ValueError):
        r.accumulate_adaptive()


def test_interruptible_rejects_live_adaptive_state(atlases):
    r = _port(atlases, seed=4)
    r.accumulate_adaptive(frac=1.0)
    with pytest.raises(ValueError):
        r.accumulate_interruptible(n_chunks=2)


def test_reset_clears_adaptive_state(atlases):
    r = _port(atlases, seed=5)
    r.accumulate_adaptive(frac=1.0)
    r.reset_framebuffer()
    assert (r.total_samples, r.current_spp, r._rng_round, r._adaptive_rounds) == (0, 0, 0, 0)
    assert not r.count_buffer.any() and not r.lum2_buffer.any()
    r2 = _port(atlases, seed=5)
    r.accumulate_adaptive(frac=1.0)
    r2.accumulate_adaptive(frac=1.0)
    assert torch.equal(r.color_buffer, r2.color_buffer)


def test_checkpoint_roundtrip(atlases, tmp_path):
    r = _port(atlases, seed=6)
    for _ in range(2):
        r.accumulate_adaptive(frac=1.0)
    r.accumulate_adaptive(frac=0.25, min_warmup=2)
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    r2 = _port(atlases, seed=99)
    r2.load_checkpoint(path)
    assert torch.equal(r.count_buffer, r2.count_buffer)
    assert (r2._rng_round, r2.total_samples, r2._seed_key) == (
        r._rng_round, r.total_samples, r._seed_key)
    r.accumulate_adaptive(frac=0.25, min_warmup=2)
    r2.accumulate_adaptive(frac=0.25, min_warmup=2)
    assert torch.equal(r.color_buffer, r2.color_buffer)
    assert torch.equal(r.count_buffer, r2.count_buffer)


def test_adaptive_pass_aborts_between_bounces(atlases):
    """An interrupt before bounce 1 drops the pass: buffers and round stay."""
    r = _port(atlases, seed=8)
    for _ in range(2):
        r.accumulate_adaptive(frac=1.0)
    before = (r.color_buffer.clone(), r.count_buffer.clone(), r.lum2_buffer.clone())
    polls = []
    assert not r.accumulate_adaptive(frac=0.25, interrupt=lambda: polls.append(1) or len(polls) == 2)
    assert len(polls) == 2
    assert all(torch.equal(a, b) for a, b in zip(before, (r.color_buffer, r.count_buffer,
                                                          r.lum2_buffer)))
    assert (r._rng_round, r._adaptive_rounds, r.total_samples) == (2, 2, 2 * RES[0] * RES[1])


# --- the two renderers side by side ---------------------------------------------


def _agree(got, want):
    """Share of pixels within rtol 1e-3 (all channels)."""
    return np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()


def test_jax_adaptive_checkpoint_resumes_in_port(atlases, tmp_path):
    jr, tr = _jax(atlases, seed=6), _port(atlases, seed=99)
    for _ in range(2):
        jr.accumulate_adaptive(frac=1.0)
    jr.accumulate_adaptive(frac=0.25)
    path = str(tmp_path / "jax.npz")
    jr.save_checkpoint(path)
    tr.load_checkpoint(path)
    assert (tr._rng_round, tr._adaptive_rounds, tr.total_samples, tr.current_spp) == (
        3, 3, jr.total_samples, 2)
    np.testing.assert_array_equal(tr.count_buffer.numpy(), np.asarray(jr.count_buffer))
    jr.accumulate_adaptive(frac=0.25)
    tr.accumulate_adaptive(frac=0.25)
    # the same buffers pick the same tiles
    np.testing.assert_array_equal(tr.count_buffer.numpy(), np.asarray(jr.count_buffer))
    share = _agree(tr.color_buffer.numpy(), np.asarray(jr.color_buffer))
    # measured: every pixel within rtol 1e-3 (the resume floor of
    # tests/test_torch_preview.py is 0.95)
    assert share >= 0.95, share


def test_port_adaptive_checkpoint_resumes_in_jax(atlases, tmp_path):
    jr, tr = _jax(atlases, seed=99), _port(atlases, seed=6)
    for _ in range(2):
        tr.accumulate_adaptive(frac=1.0)
    tr.accumulate_adaptive(frac=0.25)
    path = str(tmp_path / "port.npz")
    tr.save_checkpoint(path)
    jr.load_checkpoint(path)
    assert (jr._rng_round, jr.total_samples, jr.mean_spp) == (3, tr.total_samples, tr.mean_spp)
    jr.accumulate_adaptive(frac=0.25)
    tr.accumulate_adaptive(frac=0.25)
    np.testing.assert_array_equal(np.asarray(jr.count_buffer), tr.count_buffer.numpy())
    share = _agree(tr.color_buffer.numpy(), np.asarray(jr.color_buffer))
    assert share >= 0.95, share


def test_adaptive_run_matches_jax(atlases):
    """Warm-up plus three adaptive passes in both renderers from the same
    seed: the same tiles each pass, and per-pixel means within the golden
    floor of tests/test_torch_render.py (0.92 of pixels within rtol 1e-3)."""
    jr, tr = _jax(atlases, seed=2), _port(atlases, seed=2)
    for i in range(5):
        jr.accumulate_adaptive(frac=0.25)
        tr.accumulate_adaptive(frac=0.25)
        np.testing.assert_array_equal(tr.count_buffer.numpy(), np.asarray(jr.count_buffer),
                                      err_msg=f"pass {i}")
    assert tr.mean_spp == jr.mean_spp and tr.mean_spp != int(tr.mean_spp)
    n = tr.count_buffer.numpy()[..., None]
    share = _agree(tr.color_buffer.numpy() / n, np.asarray(jr.color_buffer) / n)
    assert share >= 0.92, share  # measured 0.9375
