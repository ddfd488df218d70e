"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and ``nvcc`` and skips without one (the
kernels have no CPU mode). The file imports no JAX, so on a machine without
it run it as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Stated tolerances (kernel vs twin, same inputs, same CUDA libm, op-by-op
rounding on both sides): hit/miss and event agreement >= 99.9%, median
relative distance error < 1e-6, mean ratio transmittance within 1e-4; the
threefry header is bit-equal. The bounce's kernels state theirs below.
"""

import os

import numpy as np
import pytest
import torch

from digital_earth_tpu_torch import constants as C
from digital_earth_tpu_torch.app.config_io import load_config
from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
from digital_earth_tpu_torch.assets.luts import load_spectral_luts
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.models import volume as vol
from digital_earth_tpu_torch.ops import rng
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render import tracers
from digital_earth_tpu_torch.render.params import TraceConfig

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16384


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def case(dev):
    """Orbit rays at the limb and disk plus near-terrain rays in random
    directions, as tests/test_torch_tracers.py builds them."""
    r = np.random.default_rng(0)

    def unit(m):
        v = r.normal(size=(m, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    h = N // 2
    pos = np.concatenate([
        unit(h) * (C.PLANET_R + r.uniform(100e3, 20000e3, (h, 1))),
        unit(N - h) * (C.PLANET_R + r.uniform(0.0, 12e3, (N - h, 1))),
    ])
    tgt = unit(h) * (C.PLANET_R + r.uniform(-60e3, 60e3, (h, 1)))
    d0 = tgt - pos[:h]
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    dirs = np.concatenate([d0, unit(N - h)])
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dev, dt)  # noqa: E731
    wl = t(r.uniform(390.0, 830.0, (N, 4)))
    luts = load_spectral_luts(dev)
    ext = torch.stack([
        vol.spectra_extinction_rayleigh(wl), vol.spectra_extinction_mie(wl),
        vol.spectra_extinction_ozone(wl, luts.o3_crossec),
    ], dim=-1)
    return dict(
        pos=t(pos), dirs=t(dirs), active=t(r.random(N) < 0.95, torch.bool),
        ext=ext, ext_h=ext[:, 0, :].contiguous(),
        atlas=build_atlas(generate_earth_textures((128, 256), seed=3), dev),
        keys=rng.lane_keys(rng.prng_key(5, dev), torch.arange(N, device=dev)),
    )


# edge keys of the threefry header's checks: k0 = k1, ks[2] = k0 ^ k1 ^
# 0x1BD11BDA = 0, one word 0 or all ones; edge data and counter runs that
# cross 2^31 and wrap past 2^32
_TF_PARITY = 0x1BD11BDA
_TF_EDGE_KEYS = ([(v, v) for v in (0, 1, 0x7FFFFFFF, 0xFFFFFFFF)]
                 + [(a, a ^ _TF_PARITY) for a in (0, 1, 0x7FFFFFFF, 0xFFFFFFFF, 0x12345678)]
                 + [(0, 0xFFFFFFFF), (0xFFFFFFFF, 0), (_TF_PARITY, 0), (0, _TF_PARITY)])
_TF_DATA = (0, 1, 5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)


def _threefry_keys(dev):
    keys = rng.lane_keys(rng.prng_key(7, dev), torch.arange(4096, device=dev) * 7919)
    keys[:len(_TF_EDGE_KEYS)] = torch.tensor(_TF_EDGE_KEYS, dtype=torch.int64, device=dev)
    return keys


@pytest.mark.parametrize("data", _TF_DATA)
def test_threefry_header_bit_equal(dev, data):
    """The header's fold, then 12 draws, and its fold at depths 1 and 2, on
    edge keys and data, bit for bit ops/rng.py."""
    from digital_earth_tpu_torch import kernels

    keys = _threefry_keys(dev)
    got = kernels.threefry_uniform(keys, data, 12)
    want = rng.uniform(rng.fold(keys, data), (12,))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    k1 = rng.fold(keys, data)
    assert torch.equal(kernels.threefry_fold(keys, data, 1), kernels.keys_i32(k1))
    assert torch.equal(kernels.threefry_fold(keys, data, 2), kernels.keys_i32(rng.fold(k1, data)))


@pytest.mark.parametrize("base", [0, 0x7FFFFFFA, 0xFFFFFFFA])
def test_threefry_draws_at_edge_counters_bit_equal(dev, base):
    """Draws from edge keys at counter runs that cross 2^31 and wrap past
    2^32, and the one- and two-word sums whose SASS gives a draw's count,
    bit for bit ops/rng.uniform_at; the launchers refuse a CPU tensor and a
    fold depth or a sum's count they do not have."""
    from digital_earth_tpu_torch import kernels

    keys = _threefry_keys(dev)
    ctr = (base + torch.arange(12, device=dev))[:, None]
    want = rng.uniform_at(keys[None], ctr)
    got = kernels.threefry_draws(keys, base, 12)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(kernels.threefry_draw_sum(keys, base, 1), want[0])
    assert torch.equal(kernels.threefry_draw_sum(keys, base, 2), want[0] + want[1])
    with pytest.raises(ValueError):
        kernels.threefry_draws(keys.cpu(), base, 12)
    with pytest.raises(ValueError):
        kernels.threefry_draw_sum(keys, base, 3)
    with pytest.raises(ValueError):
        kernels.threefry_fold(keys, base, 3)


@pytest.mark.parametrize("any_hit,capped", [(False, False), (True, False), (False, True)])
def test_land_march_kernel(case, any_hit, capped):
    from digital_earth_tpu_torch import kernels

    t_cap = None
    if capped:
        t_cap = torch.rand(N, device=case["pos"].device) * 3e7 + 1e3
    args = (case["atlas"].topography, case["pos"], case["dirs"],
            torch.tensor(7800.0, device=case["pos"].device), case["active"],
            TraceConfig())
    before = kernels.land_march.launches
    got = tracers.intersect_land(*args, t_cap=t_cap, any_hit=any_hit)
    assert kernels.land_march.launches == before + 1
    want = tracers.intersect_land_plain(*args, t_cap=t_cap, any_hit=any_hit)
    assert ((got >= 0) == (want >= 0)).float().mean().item() >= 0.999
    both = (got >= 0) & (want >= 0)
    rel = ((got - want).abs() / want.clamp(min=1.0))[both]
    assert rel.median().item() < 1e-6


@pytest.mark.parametrize("per_warp", [1, 3, 8, 9, 32])
def test_land_march_kernel_warp_cooperative(case, per_warp):
    """The warp-cooperative march (march_k = 4 threads to a marching lane,
    8 lanes a pass) on a ragged n with ``per_warp`` active lanes in each
    warp: every lane bit-equal to intersect_land_plain, and each active
    lane bit-equal to its march in a warp with every lane active (a lane's
    result does not depend on the lanes it shares its passes with)."""
    dev = case["pos"].device
    n = N - 13
    r = np.random.default_rng(per_warp)
    mask = np.zeros(n, bool)
    for w0 in range(0, n, 32):
        width = min(32, n - w0)
        mask[w0 + r.choice(width, min(per_warp, width), replace=False)] = True
    active = torch.from_numpy(mask).to(dev)
    base = (case["atlas"].topography, case["pos"][:n].contiguous(),
            case["dirs"][:n].contiguous(), torch.tensor(7800.0, device=dev))
    for any_hit in (False, True):
        got = tracers.intersect_land(*base, active, TraceConfig(), any_hit=any_hit)
        want = tracers.intersect_land_plain(*base, active, TraceConfig(), any_hit=any_hit)
        assert _bits_equal(got, want)
        full = tracers.intersect_land(*base, torch.ones(n, dtype=torch.bool, device=dev),
                                      TraceConfig(), any_hit=any_hit)
        assert _bits_equal(got[active], full[active])
        assert (got[~active] == -1.0).all()


# tracking_k: the trackers take any count of probes an iteration (the
# default 4, odd counts, more than the default)
TRACKING_KS = [1, 3, 4, 6, 8]


@pytest.mark.parametrize("k", TRACKING_KS)
def test_rmo_delta_track_kernel(case, k):
    t0, t1 = pt._rmo_span(case["pos"], case["dirs"],
                          torch.full((N,), -1.0, device=case["pos"].device))
    args = (case["keys"], case["pos"], case["dirs"], t0, t1, case["ext_h"],
            case["active"], TraceConfig(tracking_k=k))
    ge, gt, gid = tracers.delta_track_rmo(*args)
    we, wt, wid = tracers.delta_track_rmo_plain(*args)
    assert (ge == we).float().mean().item() >= 0.999
    same = (ge == we) & (ge > 0)
    assert (gid == wid)[same].float().mean().item() >= 0.999
    assert ((gt - wt).abs() / wt.abs().clamp(min=1.0))[same].median().item() < 1e-6


# tracking lanes per warp, from one to all 32: the layouts of the bounce's
# NEE lanes (warps empty, sparse or full; chip_smoke.py's census counts
# them) and of chip_smoke.py's sparse launches
RATIO_PER_WARP = [1, 2, 3, 5, 8, 9, 16, 17, 32]


def _per_warp_mask(eligible, counts, seed):
    """A mask with counts[w % len(counts)] of the eligible lanes (or all of
    them, if fewer) in each warp w of 32 consecutive lanes."""
    r = np.random.default_rng(seed)
    elig = eligible.cpu().numpy()
    mask = np.zeros(elig.size, bool)
    for w, w0 in enumerate(range(0, elig.size, 32)):
        lanes = np.flatnonzero(elig[w0:w0 + 32]) + w0
        want = min(counts[w % len(counts)], lanes.size)
        mask[r.choice(lanes, want, replace=False)] = True
    return torch.from_numpy(mask).to(eligible.device)


def _ratio_both(args, k, max_steps=8192):
    """(kernel's trans, iterations; the twin's trans, iterations)."""
    from digital_earth_tpu_torch import kernels

    got, iters = kernels.rmo_ratio_track(*args, max_steps=max_steps, k=k, iters=True)
    trips = torch.zeros(args[0].shape[0], dtype=torch.int32, device=got.device)
    want = tracers.ratio_track_rmo_plain(
        *args, TraceConfig(tracking_k=k, max_tracking_steps=max_steps), trips=trips)
    return got, iters, want, trips


@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("L", [1, 4])
def test_rmo_ratio_track_kernel(case, k, L):
    """The gases' ratio tracker (the reference's sun transmittance) bit-equal
    to its twin on every lane, active or not, at one and four wavelengths,
    each lane's iterations the twin's loop count: on the case, and on a
    ragged n with 1 ... 32 tracking lanes in a warp."""
    from digital_earth_tpu_torch import kernels

    dev = case["pos"].device
    t0, t1 = pt._rmo_span(case["pos"], case["dirs"], torch.full((N,), -1.0, device=dev))
    ext = case["ext"][:, :L].contiguous()
    args = (case["keys"], case["pos"], case["dirs"], t0, t1, ext, vol.max_extinction_rmo(ext),
            case["active"], TraceConfig(tracking_k=k))
    before = kernels.rmo_ratio_track.launches
    got = tracers.ratio_track_rmo(*args)
    assert kernels.rmo_ratio_track.launches == before + 1
    trips = torch.zeros(N, dtype=torch.int32, device=dev)
    want = tracers.ratio_track_rmo_plain(*args, trips=trips)
    assert got.shape == (N, L) and _bits_equal(got, want)
    _, iters = kernels.rmo_ratio_track(*args[:8], max_steps=8192, k=k, iters=True)
    assert torch.equal(iters, trips) and iters.max() > 1
    assert (got[~case["active"]] == 1.0).all() and got.min() < 0.5

    n = N - 13
    lanes = [a[:n].contiguous() for a in args[:7]]
    valid = (lanes[4] >= 0.0) & (lanes[3] < lanes[4])
    for per_warp in RATIO_PER_WARP:
        tracking = _per_warp_mask(valid, [per_warp], per_warp)
        got, iters, want, trips = _ratio_both((*lanes, tracking), k)
        assert _bits_equal(got, want) and torch.equal(iters, trips)
        assert torch.equal(iters > 0, tracking) and (got[~tracking] == 1.0).all()


@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("L", [1, 4])
def test_rmo_ratio_track_kernel_edges(case, k, L):
    """The ratio tracker's stops, bit-equal to its twin with its iterations,
    in warps of 1 ... 32 active lanes on a ragged n: lanes with t_start at
    or past t_max, with t_max < 0, whose first probe passes t_max (one
    iteration, no factor), thick chords (extinctions x 300) that end on
    the 1e-5 test, and max_steps 1 and 2, where the cap ends lanes."""
    dev = case["pos"].device
    n = 32 * 72 + 7
    r = np.random.default_rng(10 * k + L)
    kind = torch.from_numpy(r.integers(0, 5, n)).to(dev)
    t0, t1 = pt._rmo_span(case["pos"][:n], case["dirs"][:n], torch.full((n,), -1.0, device=dev))
    t0 = torch.where(kind == 1, t1 + torch.from_numpy(r.choice([0.0, 10.0], n)).float().to(dev), t0)
    t1 = torch.where(kind == 2, torch.full_like(t1, -1.0), t1)
    t0 = torch.where(kind == 3, 0.0, t0)
    t1 = torch.where(kind == 3, 1e-4, t1)  # under a step's least, 0.002 m
    ext = case["ext"][:n, :L] * torch.where(kind == 4, 300.0, 1.0)[:, None, None]
    active = _per_warp_mask(torch.ones(n, dtype=torch.bool, device=dev), RATIO_PER_WARP, k)
    args = (case["keys"][:n], case["pos"][:n].contiguous(), case["dirs"][:n].contiguous(), t0,
            t1, ext.contiguous(), vol.max_extinction_rmo(ext), active)
    full = None
    for max_steps in (8192, 1, 2):
        got, iters, want, trips = _ratio_both(args, k, max_steps)
        assert _bits_equal(got, want) and torch.equal(iters, trips)
        assert (iters[active & ((kind == 1) | (kind == 2))] == 0).all()
        first = active & (kind == 3)
        assert first.any() and (iters[first] == 1).all() and (got[first] == 1.0).all()
        if max_steps == 8192:
            full = iters
            thick = active & (kind == 4) & (got.amax(-1) < 1e-5)
            assert thick.any() and (iters[thick] < max_steps).all()
        else:
            assert iters.max() == max_steps and (full > max_steps).any()


@pytest.mark.parametrize("k", TRACKING_KS)
@pytest.mark.parametrize("mode", ["delta", "ratio"])
def test_cloud_track_kernel(case, mode, k):
    no_land = torch.full((N,), -1.0, device=case["pos"].device)
    cs, cm = pt.intersect_cloud_limits(case["pos"], case["dirs"], no_land)
    ext_w = torch.full((N,), C.CLOUDS_EXTINCT, device=case["pos"].device)
    args = (case["keys"], case["pos"], case["dirs"], cs, cm, ext_w,
            case["atlas"].clouds, case["active"], TraceConfig(tracking_k=k), mode)
    got = tracers.track_cloud(*args)
    want = tracers.track_cloud_plain(*args)
    if mode == "delta":
        assert (got[0] == want[0]).float().mean().item() >= 0.999
        same = (got[0] == want[0]) & (got[0] > 0)
        rel = ((got[1] - want[1]).abs() / want[1].clamp(min=1.0))[same]
        assert rel.median().item() < 1e-6
    else:
        assert abs(got.mean().item() - want.mean().item()) < 1e-4


def test_launchers_check_their_inputs(case):
    from digital_earth_tpu_torch import kernels

    n = 8
    ok = dict(step_floor=100.0, stall_thresh=25.0, steps=16, k=4, patience=2,
              any_hit=False)
    topo = case["atlas"].topography
    pos = case["pos"][:n].contiguous()
    act = case["active"][:n].contiguous()
    cap = torch.full((n,), float("inf"), device=pos.device)
    with pytest.raises(ValueError, match="dtype"):
        kernels.land_march(topo, pos.double(), pos, act, cap, 7800.0, **ok)
    with pytest.raises(ValueError, match="contiguous"):
        strided = case["pos"][: 2 * n : 2]
        kernels.land_march(topo, strided, pos, act, cap, 7800.0, **ok)
    with pytest.raises(ValueError, match="shape"):
        kernels.land_march(topo, pos, pos, act[:4], cap, 7800.0, **ok)
    with pytest.raises(ValueError, match="expected"):
        kernels.land_march(topo, pos.cpu(), pos, act, cap, 7800.0, **ok)


def test_main_path_uses_every_kernel_and_matches_golden(dev):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.viewer import render_offline

    golden = np.load(os.path.join(ROOT, "tests", "golden", "apollo_path.npz"))
    kernels.reset_launch_counts()
    r = render_offline(
        load_config(os.path.join(ROOT, "scenes", "config - Apollo 11.txt")), dev,
        spp=int(golden["spp"]), image_res=(32, 18), out_path=None,
        atlas=build_atlas(generate_earth_textures((64, 128), seed=3), dev), seed=0,
        cfg=TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256),
    )
    r.fetch_image()
    counts = kernels.launch_counts()
    # 576 lanes fill no card: every bounce of the frame runs in bounce_window
    main_path = ("bounce_window", "compact_lanes", "gen_rays", "frame_end", "film_postprocess")
    assert all(counts[k] > 0 for k in main_path), counts
    assert counts["compact_lanes"] == counts["bounce_flight"] + counts["bounce_window"], counts
    # the loops run inside bounce; the other paths' kernels do not launch
    others = ("land_march", "rmo_delta_track", "cloud_track", "atmos_march", "select_tiles",
              "select_tiles_shard", "preview")
    assert all(counts[k] == 0 for k in others), counts
    buf = r.color_buffer.cpu().numpy()
    share = np.isclose(buf, golden["color_buffer"], rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= 0.90


# --- the viewer path's kernels: gen_rays, atmos_march, preview, film --------
# Stated tolerances (kernel vs twin, same inputs, on the card): gen_rays
# bit-equal in every field (the kernel multiplies by float32(1 / b) where the
# twin's CUDA ops apply a Python divisor b); atmos_march in-scatter and
# transmittance and the preview radiance within 1e-4 relative on at least
# 99.9% of lanes; film output within 1e-4.


def _apollo_renderer(dev, res, mode):
    from digital_earth_tpu_torch.app.config_io import apply_config
    from digital_earth_tpu_torch.render.renderer import Renderer

    r = Renderer(dev, image_res=res, mode=mode,
                 atlas=build_atlas(generate_earth_textures((64, 128), seed=3), dev))
    apply_config(r, load_config(os.path.join(ROOT, "scenes", "config - Apollo 11.txt")))
    return r


def _rays_equal(got, want):
    """Every field of two Rays bit-equal (floats compared as their bits)."""
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if g.is_floating_point():
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w), name


@pytest.mark.parametrize("options", [
    dict(stratify_spp=False), dict(hero_lambdas=1),
    dict(hero_lambdas=1, stratify_spp=False, analytic_transmittance=False),
])
@pytest.mark.parametrize("mode,res", [("path", (320, 180)), ("preview", (160, 90))])
def test_gen_rays_kernel_reference_estimator(dev, mode, res, options):
    """gen_rays at the reference estimator's modes (independent uniform
    primary samples; one wavelength a path lane) bit-equal to its twin."""
    from digital_earth_tpu_torch.render import raygen

    r = _apollo_renderer(dev, res, mode)
    block = r.block if mode == "preview" else (1, res[1])
    n = res[0] * res[1]
    args = ((0, 3), 5, 0, n, res, block, r.camera_params(), r.luts, mode == "preview", None,
            TraceConfig(**options))
    got = raygen.gen_rays(*args)
    assert got.wavelengths.shape[1] == (1 if mode == "preview" else options.get("hero_lambdas", 4))
    _rays_equal(got, raygen.gen_rays_plain(*args))


@pytest.mark.parametrize("mode,res", [("path", (320, 180)), ("preview", (160, 90))])
def test_gen_rays_kernel(dev, mode, res):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raygen

    r = _apollo_renderer(dev, res, mode)
    block = r.block if mode == "preview" else (1, res[1])
    n = res[0] * res[1]
    args = ((0, 3), 5, 0, n, res, block, r.camera_params(), r.luts, mode == "preview")
    before = kernels.gen_rays.launches
    got = raygen.gen_rays(*args)
    assert kernels.gen_rays.launches == before + 1
    _rays_equal(got, raygen.gen_rays_plain(*args))


def test_gen_rays_kernel_captured_in_a_cuda_graph(dev):
    """The wrapper reads nothing back from the card and launches nothing but
    the kernel: a CUDA graph captures it, and its replay writes the rays."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raygen

    r = _apollo_renderer(dev, (320, 180), "path")
    args = ((0, 3), 2, 0, 320 * 180, (320, 180), (1, 180), r.camera_params("cpu"), r.luts,
            False)
    want = raygen.gen_rays_plain(*args)
    raygen.gen_rays(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.gen_rays.launches
    with torch.cuda.graph(graph):
        got = raygen.gen_rays(*args)
    assert kernels.gen_rays.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    _rays_equal(got, want)


def test_atmos_march_kernel(case):
    """The warp-cooperative march (16 threads to a lane) bit-equal to its
    twin on every lane, active or not; n not a multiple of the block."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import math_utils as mu
    from digital_earth_tpu_torch.render import raymarcher

    n = N - 45
    pos, dirs = case["pos"][:n], case["dirs"][:n]
    a_near, a_far = mu.rsi(pos, dirs, C.ATMOS_UPPER_LIMIT)
    t0 = torch.clamp(a_near, min=0.0)
    sun = torch.nn.functional.normalize(torch.randn_like(pos) * 0.1 + dirs.roll(1, 0), dim=-1)
    ext = case["ext_h"][:n].contiguous()
    scat = torch.stack([ext[:, 0], ext[:, 1] * C.AEROSOL_ALBEDO], dim=-1)
    active = case["active"][:n] & (a_far >= 0.0)
    args = (pos, dirs, t0, a_far, sun.contiguous(), ext, scat, active)
    got = kernels.atmos_march(*args, mie_e=C.MIE_ASYMMETRY)
    want = raymarcher.ray_march_atmos_plain(*args)
    assert 0.3 < active.float().mean().item() < 1.0
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _preview_lanes(dev, res, bilinear):
    """The march_paths arguments of one Apollo 11 preview frame at ``res``
    on a small procedural atlas, as render/renderer.trace_lanes builds them."""
    from digital_earth_tpu_torch.render import raygen

    r = _apollo_renderer(dev, res, "preview")
    n = res[0] * res[1]
    rays = raygen.gen_rays(r._seed_key, 0, 0, n, res, r.block, r.camera_params(), r.luts, True)
    tidx, li, _, _ = raygen.tile_pixel_coords(torch.arange(n, device=dev), res, r.block)
    pos = r.camera_params().position.expand(n, 3).contiguous()
    cfg = TraceConfig(bilinear_materials=bilinear)
    args = (rng.fold(torch.tensor(r._seed_key, dtype=torch.int64), 0), pos, rays.dirs,
            rays.wavelengths[:, 0], r.scene_params(), r.atlas, r.luts, cfg)
    return args, dict(tile_index=tidx, lane=li, tile=r.tile)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("bilinear", [True, False])
def test_preview_kernel(dev, bilinear):
    """preview (csrc/preview.cu) bit-equal to march_paths_plain on every
    lane of a 160x90 frame (surface, sky and atmosphere-miss lanes share
    warps), with the origin by value as trace_lanes passes it."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raymarcher

    args, kw = _preview_lanes(dev, (160, 90), bilinear)
    before = (kernels.preview.launches, kernels.atmos_march.launches,
              kernels.land_march.launches)
    frame = raymarcher.PreviewFrame(*args[4:8], kw["tile"])
    key, pos = args[0], args[1]
    got = kernels.preview(frame.fparams, frame.iparams, key.tolist(), None, *args[2:4],
                          kw["tile_index"], kw["lane"], args[5].topography, args[5].material,
                          args[5].stars, args[6].o3_crossec, args[6].srgb2spec,
                          origin=pos[0].tolist())
    assert (kernels.preview.launches, kernels.atmos_march.launches,
            kernels.land_march.launches) == (before[0] + 1, before[1], before[2])
    want = raymarcher.march_paths_plain(*args, **kw)
    assert (want > 0).float().mean().item() > 0.3
    assert _bits_equal(got, want)
    assert _bits_equal(raymarcher.march_paths(*args, **kw), want)


def test_preview_census_keeps_the_bits(dev):
    """The census instance gives the timed kernel's radiance, bit for bit,
    and each lane's cycles in its land marches and its march within its
    whole."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raymarcher

    args, kw = _preview_lanes(dev, (160, 90), True)
    frame = raymarcher.PreviewFrame(*args[4:8], kw["tile"])
    key, pos, dirs, wl, _, atlas, luts, _ = args
    launch = lambda **k: kernels.preview(  # noqa: E731
        frame.fparams, frame.iparams, key.tolist(), pos, dirs, wl, kw["tile_index"], kw["lane"],
        atlas.topography, atlas.material, atlas.stars, luts.o3_crossec, luts.srgb2spec, **k)
    got, cycles = launch(census=True)
    assert _bits_equal(got, launch())
    assert cycles.shape == (dirs.shape[0], 3) and (cycles >= 0).all()
    assert (cycles[:, 0] + cycles[:, 1] <= cycles[:, 2]).all() and cycles[:, 1].sum() > 0


@pytest.mark.parametrize("lanes", ["ragged", "tile_list", "one_tile"])
def test_preview_kernel_lane_sets(dev, lanes):
    """preview bit-equal to its twin on n not a multiple of the block (a
    frame's lanes less 37), on lanes of a tile list (tiles out of order,
    in-tile lanes shuffled) and on one tile of n lanes keyed by its tile key."""
    from digital_earth_tpu_torch.render import raymarcher

    args, kw = _preview_lanes(dev, (160, 90), True)
    key, pos, dirs, wl = args[:4]
    n = dirs.shape[0]
    g = torch.Generator().manual_seed(3)
    if lanes == "ragged":
        sel = torch.arange(n - 37)
    else:
        sel = torch.randperm(n, generator=g)[: 3 * 1000 + 11]
    sel = sel.to(dev)
    args = (key, pos[sel].contiguous(), dirs[sel].contiguous(), wl[sel].contiguous(), *args[4:])
    if lanes == "one_tile":
        kw = {}
        args = (rng.fold(key, 7), *args[1:])
    elif lanes == "tile_list":
        kw = dict(tile_index=(kw["tile_index"][sel] * 5 + 3) % 97, lane=kw["lane"][sel],
                  tile=kw["tile"])
    else:
        kw = dict(tile_index=kw["tile_index"][sel], lane=kw["lane"][sel], tile=kw["tile"])
    got = raymarcher.march_paths(*args, **kw)
    want = raymarcher.march_paths_plain(*args, **kw)
    assert _bits_equal(got, want)


def test_preview_frame_bit_equal_with_the_kept_blocks(dev, monkeypatch):
    """A 64x36 preview frame on the card is the same, bit for bit, with the
    Renderer's kept parameter blocks as with blocks built on each call (the
    kernel reads them; the CPU twin takes none)."""
    from digital_earth_tpu_torch.render import renderer as trenderer

    kept = _apollo_renderer(dev, (64, 36), "preview")
    fresh = _apollo_renderer(dev, (64, 36), "preview")
    kept.accumulate()
    kept.accumulate()
    monkeypatch.setattr(trenderer.Renderer, "_frame", lambda self, scene: None)
    fresh.accumulate()
    fresh.accumulate()
    assert kept._preview_frame is not None and fresh._preview_frame is None
    assert _bits_equal(kept.color_buffer, fresh.color_buffer)
    assert (kept.color_buffer > 0).float().mean().item() > 0.3


def test_preview_launcher_checks_its_inputs(dev):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raymarcher

    args, kw = _preview_lanes(dev, (64, 36), True)
    key, pos, dirs, wl, scene, atlas, luts, cfg = args
    frame = raymarcher.PreviewFrame(scene, atlas, luts, cfg, kw["tile"])
    tables = (atlas.topography, atlas.material, atlas.stars, luts.o3_crossec, luts.srgb2spec)

    def launch(pos=pos, dirs=dirs, wl=wl, tidx=kw["tile_index"], li=kw["lane"],
               fparams=frame.fparams):
        return kernels.preview(fparams, frame.iparams, key.tolist(), pos, dirs, wl, tidx, li,
                               *tables)

    assert launch().shape == wl.shape
    with pytest.raises(ValueError, match="expected"):
        launch(pos=pos.cpu())
    with pytest.raises(ValueError, match="dtype"):
        launch(wl=wl.double())
    with pytest.raises(ValueError, match="dtype"):
        launch(tidx=kw["tile_index"].to(torch.int32))
    with pytest.raises(ValueError, match="shape"):
        launch(dirs=dirs[:10].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        launch(dirs=dirs.t().contiguous().t())
    with pytest.raises(ValueError, match="together"):
        launch(li=None)
    with pytest.raises(ValueError, match="parameters"):
        launch(fparams=frame.fparams[:-1])
    with pytest.raises(ValueError, match="pos or origin"):
        kernels.preview(frame.fparams, frame.iparams, key.tolist(), pos, dirs, wl,
                        kw["tile_index"], kw["lane"], *tables, origin=(0.0, 0.0, 7e6))


@pytest.mark.parametrize("drt", ["opendrt", "agx", "none"])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_film_postprocess_kernel(dev, drt, per_pixel):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.assets.luts import load_crf_pack
    from digital_earth_tpu_torch.render import film

    g = torch.Generator().manual_seed(1)
    buf = (torch.rand((96, 54, 3), generator=g) ** 4 * 40.0).to(dev)
    spp = (torch.randint(0, 6, (96, 54, 1), generator=g).float().to(dev)
           if per_pixel else 3.0)
    crf = load_crf_pack(dev).curves
    before = kernels.film_postprocess.launches
    got = film.postprocess(buf, spp, 1.5, 1.2, crf, 4, drt)
    assert kernels.film_postprocess.launches == before + 1
    want = film.postprocess_plain(buf, spp, 1.5, 1.2, crf, 4, drt)
    assert (got - want).abs().max().item() <= 1e-4


# --- adaptive sampling's kernels: gen_rays from a tile list, frame_end,
# select_tiles. Stated tolerances (kernel vs twin, same inputs, on the card):
# gen_rays as above; frame_end RGB and lum^2 within 1e-5 relative (with a
# floor of 1e-6 of the largest value for channels that cancel in xyz_to_rgb),
# counts exact; select_tiles the same ids in the same order (both sum in the
# same fixed order).


@pytest.mark.parametrize("mode,lane0", [("path", 0), ("path", 2 * 64 + 17), ("preview", 100)])
def test_gen_rays_kernel_from_a_tile_list(dev, mode, lane0):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raygen

    r = _apollo_renderer(dev, (320, 180), mode)
    bw, bh = r.block
    n_tiles = (320 // bw) * (180 // bh)
    ids = torch.randperm(n_tiles, generator=torch.Generator().manual_seed(2))[: n_tiles // 4]
    ids = ids.to(torch.int32).to(dev)
    args = ((0, 3), 5, lane0, ids.numel() * bw * bh - lane0, (320, 180), r.block,
            r.camera_params(), r.luts, mode == "preview", ids)
    before = kernels.gen_rays.launches
    got = raygen.gen_rays(*args)
    assert kernels.gen_rays.launches == before + 1
    _rays_equal(got, raygen.gen_rays_plain(*args))


@pytest.mark.parametrize("mode", ["path", "preview"])
def test_trace_lanes_pid_matches_the_twin(dev, mode, monkeypatch):
    """trace_lanes deposits each lane at the pid the kernel wrote, which is
    the twin's, without recomputing the pixel map."""
    from digital_earth_tpu_torch.render import frame_end as fe
    from digital_earth_tpu_torch.render import raygen

    res = (64, 36)
    r = _apollo_renderer(dev, res, mode)
    r.cfg = TraceConfig(max_bounces=2, land_march_steps=64, max_tracking_steps=256)
    seen = {}
    deposit = fe.frame_end

    def keep(responses, pid, *args, **kwargs):
        seen["pid"] = pid.clone()
        return deposit(responses, pid, *args, **kwargs)

    block = r.block if mode == "preview" else (1, res[1])
    want = raygen.gen_rays_plain(r._seed_key, 0, 0, res[0] * res[1], res, block,
                                 r.camera_params("cpu"), r.luts, mode == "preview")

    def recomputed(*args, **kwargs):
        raise AssertionError("trace_lanes recomputed the pixel map")

    monkeypatch.setattr(fe, "frame_end", keep)
    monkeypatch.setattr(raygen, "tile_pixel_coords", recomputed)
    r.accumulate()
    assert torch.equal(seen["pid"], want.pid)


def _rel_close(got, want, rtol=1e-5):
    atol = 1e-6 * want.abs().max().clamp(min=1e-30)
    return bool(((got - want).abs() <= rtol * want.abs() + atol).all())


@pytest.mark.parametrize("counts", [False, True])
def test_frame_end_kernel(dev, counts):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import frame_end as fe
    from digital_earth_tpu_torch.render.params import make_scene_params

    g = torch.Generator().manual_seed(3)
    n, L, n_pix = 50000, 4, 80000
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    scene = make_scene_params(dev, 1.0, -0.5)
    d[:5000] = torch.nn.functional.normalize(
        scene.light_direction.cpu() + 1e-3 * torch.randn((5000, 3), generator=g), dim=-1)
    rad = torch.exp(torch.randn((n, L), generator=g) * 2 - 2)
    rad[torch.rand((n, L), generator=g) < 0.02] = float("nan")
    fields = dict(
        pos=torch.zeros((n, 3)), direction=d, wavelength=torch.rand((n, L), generator=g) * 441 + 390,
        lambda_pdf=torch.rand((n, L), generator=g) * 0.01,
        throughput=torch.rand((n, L), generator=g) * 1.5, radiance=rad,
        w_mis=torch.rand((n, L), generator=g) + 0.5, alive=torch.zeros(n, dtype=torch.bool),
        primary_miss=torch.rand(n, generator=g) < 0.4, rng=torch.zeros((n, 2), dtype=torch.int64),
        work_class=torch.zeros(n, dtype=torch.int32))
    st = pt.TraceState(**{k: v.to(dev) for k, v in fields.items()})
    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), dev)
    miss = fe.MissShading(st, scene, atlas, load_spectral_luts(dev), TraceConfig())
    responses = (torch.rand((n, L, 3), generator=g) * 2).to(dev)
    pid = torch.randperm(n_pix, generator=g)[:n].to(dev)
    base = (torch.rand((n_pix, 3), generator=g) * 5).to(dev)
    outs = []
    for fn in (fe.frame_end, fe.frame_end_plain):
        color = base.clone()
        cnt = torch.ones(n_pix, device=dev) if counts else None
        l2 = torch.ones(n_pix, device=dev) if counts else None
        before = kernels.frame_end.launches
        fn(responses, pid, color, cnt, l2, miss=miss)
        outs.append((color, cnt, l2, kernels.frame_end.launches - before))
    (kc, kn, kl, k_launch), (pc, pn, pl, p_launch) = outs
    assert (k_launch, p_launch) == (1, 0)
    assert _rel_close(kc, pc)
    if counts:
        assert torch.equal(kn, pn) and _rel_close(kl, pl)


def test_frame_end_kernel_preview(dev):
    from digital_earth_tpu_torch.render import frame_end as fe

    g = torch.Generator().manual_seed(4)
    n = 20000
    rad = (torch.rand((n, 1), generator=g) * 3).to(dev)
    resp = (torch.rand((n, 1, 3), generator=g) * 2).to(dev)
    pdf = (torch.rand((n, 1), generator=g) * 300).to(dev)
    pid = torch.randperm(n, generator=g).to(dev)
    got, want = torch.zeros((n, 3), device=dev), torch.zeros((n, 3), device=dev)
    fe.frame_end(resp, pid, got, radiance=rad, pdf=pdf)
    fe.frame_end_plain(resp, pid, want, radiance=rad, pdf=pdf)
    assert _rel_close(got, want)


def _select_bufs(dev, res, block, seed, case="finite"):
    g = torch.Generator().manual_seed(seed)
    w, h = res
    count = torch.randint(1, 6, (w, h), generator=g).float()
    count[: block[0], : block[1]] = 0.0  # a never-sampled tile
    color = torch.exp(torch.randn((w, h, 3), generator=g)) * count[..., None]
    lum2 = color.sum(-1) ** 2 / count.clamp(min=1) * (1 + torch.rand((w, h), generator=g))
    bw, bh = block
    for arr in (color, count, lum2):  # an exact tie: tile 2 copied onto tile 5
        nby = h // bh
        (ax, ay), (cx, cy) = divmod(2, nby), divmod(5, nby)
        arr[cx * bw:(cx + 1) * bw, cy * bh:(cy + 1) * bh] = arr[ax * bw:(ax + 1) * bw,
                                                                  ay * bh:(ay + 1) * bh]
    if case == "inf_color":
        color[17, 40, 1] = float("inf")
    elif case == "neg_inf_color":
        color[33, 20, 2] = float("-inf")
    elif case == "nan_color":
        color[200, 100, 0] = float("nan")
    elif case == "nan_lum2":
        lum2[100, 50] = float("nan")
    return [t.to(dev).contiguous() for t in (color, count, lum2)]


def _select_stats_plain(bufs, block):
    from digital_earth_tpu_torch.render import adaptive

    color, count, lum2 = bufs
    m_bar = adaptive.shard_mean_plain(color.reshape(-1, 3), count.reshape(-1))
    return m_bar, adaptive.tile_scores_plain(color, count, lum2, block)


@pytest.mark.parametrize("res,tile_pixels", [((320, 180), 2048), ((1920, 1080), 2048),
                                             ((96, 60), 64), ((1000, 30), 600),
                                             ((3200, 1800), 1024)])
def test_select_tiles_kernel(dev, res, tile_pixels):
    """ids, m_bar and every tile score bit-equal to the twin's, k = 1 ...
    n_tiles, two launches a call, calls back to back (each launch's ticket
    reset by its last block); tile counts that are not powers of two, and
    6000 tiles (past 4096, where the rank sorts 8 keys to a thread)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import adaptive, raygen

    w, h = res
    block = raygen.pick_block_dims(w, h, tile_pixels)
    n_tiles = (w // block[0]) * (h // block[1])
    bufs = _select_bufs(dev, res, block, 5)
    m_want, s_want = _select_stats_plain(bufs, block)
    for k in (1, max(1, n_tiles // 4), n_tiles, n_tiles):
        before = kernels.select_tiles.launches
        got, m_bar, scores = kernels.select_tiles(adaptive._kernel_params(), *bufs, block, k,
                                                  stats=True)
        assert kernels.select_tiles.launches == before + kernels.SELECT_TILES_STAGES == before + 2
        want = adaptive.select_tiles_plain(*bufs, block, k)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert _bits_equal(m_bar, m_want.reshape(1)) and _bits_equal(scores, s_want)
        assert torch.equal(adaptive.select_tiles(*bufs, block, k), want)


@pytest.mark.parametrize("res,tile_pixels,n_tiles,launches", [
    ((4096, 2160), 2048, 4608, 2),     # more than 1024 x 8192 pixels: 4608 tiles of 32x60
    ((3840, 2160), 512, 17280, 4),     # more than 8192 tiles: 17280 of 20x24
    ((7680, 4320), 2048, 17280, 4),    # both: 17280 tiles of 40x48
    ((512, 256), 16384, 8, 2),         # tiles of more than 8192 pixels: 128x128
    # more than 8192 tiles of fewer than 64 pixels, whose sums take warp 0 alone
    ((128, 72), 1, 9216, 4),           # 1x1
    ((512, 288), 16, 9216, 4),         # 4x4
    ((512, 576), 32, 9216, 4),         # 4x8
    ((1920, 1080), 16, 129600, 4),     # 1080p at 4x4
])
def test_select_tiles_kernel_past_the_old_caps(dev, res, tile_pixels, n_tiles, launches):
    """The sizes the kernel once refused: ids, m_bar and every tile score
    bit-equal to the twin's, k = 1 ... n_tiles; past 8192 tiles the rank
    takes two more launches (sorted runs of 8192 keys, then each key's place
    among the runs), with tiles of any size down to one pixel."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import adaptive, raygen

    w, h = res
    block = raygen.pick_block_dims(w, h, tile_pixels)
    assert (w // block[0]) * (h // block[1]) == n_tiles
    assert kernels.select_launches(n_tiles) == launches
    bufs = _select_bufs(dev, res, block, 12)
    m_want, s_want = _select_stats_plain(bufs, block)
    for k in (1, max(1, n_tiles // 4), n_tiles, n_tiles):
        before = kernels.select_tiles.launches
        got, m_bar, scores = kernels.select_tiles(adaptive._kernel_params(), *bufs, block, k,
                                                  stats=True)
        assert kernels.select_tiles.launches == before + launches
        assert torch.equal(got, adaptive.select_tiles_plain(*bufs, block, k))
        assert _bits_equal(m_bar, m_want.reshape(1)) and _bits_equal(scores, s_want)


def test_select_tiles_kernel_past_the_old_caps_in_a_cuda_graph(dev):
    """17280 tiles (four launches) captured in a CUDA graph and replayed on
    new buffers: the twin's ids."""
    from digital_earth_tpu_torch.render import adaptive, raygen

    res = (3840, 2160)
    block = raygen.pick_block_dims(*res, 512)
    bufs = _select_bufs(dev, res, block, 13)
    k = 4320
    adaptive.select_tiles(*bufs, block, k)  # the scratch, made outside the capture
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        adaptive.select_tiles(*bufs, block, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ids = adaptive.select_tiles(*bufs, block, k)
    for seed in (14, 15):
        for dst, src in zip(bufs, _select_bufs(dev, res, block, seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(ids, adaptive.select_tiles_plain(*bufs, block, k))


@pytest.mark.parametrize("case", ["inf_color", "neg_inf_color", "nan_color", "nan_lum2"])
def test_select_tiles_kernel_with_nan_scores(dev, case):
    """Non-finite buffer values give NaN or infinite scores: the kernel
    still writes k distinct tiles in range, the same as its twin (XLA's total
    order), with the same m_bar and scores, bit for bit."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import adaptive, raygen

    w, h = 320, 180
    block = raygen.pick_block_dims(w, h, 2048)
    n_tiles = (w // block[0]) * (h // block[1])
    bufs = _select_bufs(dev, (w, h), block, 6, case)
    m_want, s_want = _select_stats_plain(bufs, block)
    assert not torch.isfinite(s_want).all()
    for k in (1, n_tiles // 4, n_tiles):
        got, m_bar, scores = kernels.select_tiles(adaptive._kernel_params(), *bufs, block, k,
                                                  stats=True)
        want = adaptive.select_tiles_plain(*bufs, block, k)
        assert torch.equal(got, want)
        assert _bits_equal(m_bar, m_want.reshape(1)) and _bits_equal(scores, s_want)
        assert got.unique().numel() == k and 0 <= got.min().item() and got.max().item() < n_tiles


def test_select_tiles_kernel_captured_in_a_cuda_graph(dev):
    """A call reads nothing back from the card and allocates only its ids,
    so a CUDA graph captures it; replayed on new buffers (copied into the
    captured ones) it gives the twin's ids."""
    from digital_earth_tpu_torch.render import adaptive, raygen

    res = (320, 180)
    block = raygen.pick_block_dims(*res, 2048)
    bufs = _select_bufs(dev, res, block, 8)
    k = 7
    adaptive.select_tiles(*bufs, block, k)  # the scratch, made outside the capture
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        adaptive.select_tiles(*bufs, block, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ids = adaptive.select_tiles(*bufs, block, k)
    for seed in (9, 10):
        for dst, src in zip(bufs, _select_bufs(dev, res, block, seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(ids, adaptive.select_tiles_plain(*bufs, block, k))


# --- one device's shard of a render mesh: shard_mean, select_tiles_shard -----
# Stated tolerance: the shard mean bit-equal to its twin (the same halving
# trees), the ids equal in order; a (4, 1) mesh over one card bit-equal to
# the Renderer (per-lane kernels, one add per pixel).


def _shard_bufs(dev, n_tiles, tile, case="finite"):
    g = torch.Generator().manual_seed(7)
    n = n_tiles * tile
    count = torch.randint(1, 6, (n,), generator=g).float()
    count[:tile] = 0.0  # a never-sampled tile
    color = torch.exp(torch.randn((n, 3), generator=g)) * count[:, None]
    lum2 = color.sum(-1) ** 2 / count.clamp(min=1) * (1 + torch.rand((n,), generator=g))
    for arr in (color, count, lum2):  # an exact tie: tile 2 copied onto tile 5
        arr[5 * tile:6 * tile] = arr[2 * tile:3 * tile]
    if case == "nan_lum2":
        lum2[n // 2] = float("nan")
    elif case == "inf_color":
        color[n // 3, 1] = float("inf")
    elif case == "neg_inf_color":
        color[n // 3, 2] = float("-inf")
    return [t.to(dev).contiguous() for t in (color, count, lum2)]


@pytest.mark.parametrize("n_tiles,tile,case", [(270, 1920, "finite"), (8, 64, "finite"),
                                               (270, 1920, "nan_lum2"), (100, 48, "inf_color"),
                                               (100, 48, "neg_inf_color"),
                                               (5000, 64, "finite"), (9216, 64, "finite"),
                                               (9216, 64, "nan_lum2"), (4608, 1920, "finite"),
                                               (9216, 1, "finite"), (9216, 16, "finite"),
                                               (9216, 32, "finite")])
def test_select_tiles_shard_kernel(dev, n_tiles, tile, case):
    """The shard entries against their twins: the shard mean, the ids and
    every tile score bit-equal, with ties, NaN and +-inf, k = 1 ... n_tiles
    (twice in a row), one launch per entry (three for a selection past 8192
    tiles); past 8192 tiles (with tiles of 64, 32, 16 and 1 pixels) and past
    1024 x 8192 pixels (4608 x 1920)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import adaptive

    bufs = _shard_bufs(dev, n_tiles, tile, case)
    before = kernels.select_tiles_shard.launches
    mean = adaptive.shard_mean(*bufs[:2])
    assert _bits_equal(mean, adaptive.shard_mean_plain(*bufs[:2]))
    m_bar = mean * 0.8
    for k in (1, n_tiles // 4, n_tiles, n_tiles):
        got, scores = kernels.select_tiles_shard(adaptive._kernel_params(), *bufs, tile, k, m_bar,
                                                 stats=True)
        want = adaptive.select_tiles_shard_plain(*bufs, tile, k, m_bar)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert _bits_equal(scores, adaptive.shard_scores_plain(*bufs, tile, m_bar))
        assert got.unique().numel() == k
    # one launch per shard mean, one per shard selection (three past 8192 tiles)
    per_selection = kernels.select_launches(n_tiles) - 1
    assert per_selection == (3 if n_tiles > 8192 else 1)
    assert kernels.select_tiles_shard.launches == before + 1 + 4 * per_selection


def test_select_tiles_shard_step_captured_in_a_cuda_graph(dev):
    """A shard's mean and selection read nothing back from the card: a CUDA
    graph captures both; replayed on new buffers it gives the twins' ids."""
    from digital_earth_tpu_torch.render import adaptive

    n_tiles, tile, k = 100, 48, 9
    bufs = _shard_bufs(dev, n_tiles, tile)

    def step():
        return adaptive.select_tiles_shard(*bufs, tile, k, adaptive.shard_mean(*bufs[:2]))

    step()  # the scratch, made outside the capture
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ids = step()
    for case in ("inf_color", "nan_lum2"):
        for dst, src in zip(bufs, _shard_bufs(dev, n_tiles, tile, case)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        m_bar = adaptive.shard_mean_plain(*bufs[:2])
        assert torch.equal(ids, adaptive.select_tiles_shard_plain(*bufs, tile, k, m_bar))


def _mesh_renderers(devices, n_spp=1, res=(320, 180), trace=TraceConfig()):
    from digital_earth_tpu_torch.app.config_io import apply_config
    from digital_earth_tpu_torch.parallel.mesh import MultiChipRenderer, make_render_mesh
    from digital_earth_tpu_torch.render.renderer import Renderer

    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), devices[0])
    cfg = load_config(os.path.join(ROOT, "scenes", "config - Apollo 11.txt"))
    m = MultiChipRenderer(make_render_mesh(devices, spp_axis=n_spp), res, atlas=atlas, seed=5,
                          cfg=trace)
    s = Renderer(devices[0], res, atlas=atlas, seed=5, cfg=trace)
    for r in (m, s):
        apply_config(r, cfg)
    return m, s


def test_mesh_on_one_card_matches_renderer(dev):
    from digital_earth_tpu_torch import kernels

    m, s = _mesh_renderers([torch.device("cuda:0")] * 4)
    for _ in range(2):
        m.accumulate()
        s.accumulate()
    assert torch.equal(m.color_buffer, s.color_buffer)
    kernels.reset_launch_counts()
    a, _ = _mesh_renderers([torch.device("cuda:0")] * 4)
    for _ in range(3):
        assert a.accumulate_adaptive(frac=0.25)
    assert kernels.launch_counts()["select_tiles_shard"] == 4 * kernels.SELECT_TILES_STAGES
    counts = torch.stack(a._count).view(4, a.tiles_per_dev, a.tile)[..., 0]
    assert ((counts == 3.0).sum(1) == max(1, int(a.tiles_per_dev * 0.25))).all()


def test_mesh_over_distinct_cards_matches_renderer(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    m, s = _mesh_renderers([torch.device(f"cuda:{i}") for i in range(n)])
    for _ in range(2):
        m.accumulate()
        s.accumulate()
    assert torch.equal(m.color_buffer, s.color_buffer)


# --- the bounce: bounce_flight, bounce_shade, bounce_window, compact_lanes ---
# Stated tolerances (kernel vs twin, same inputs, on the card): compact_lanes
# bit-equal; bounce on at least 99% of a 32x18 frame's live lanes the same
# alive, primary_miss and work_class and every value within 1e-4 relative
# (atol 1e-6 of each field's largest value; one flipped lane is 0.2% of 576),
# directions within 1e-6 absolute (bit-equal on the card since the Draine
# lobe's divisor is rounded as PyTorch rounds it; chip_smoke.py DIR_ANGLE);
# density_check within 1e-4 relative on at least 99.9% of lanes.


APOLLO = "config - Apollo 11.txt"
NAIVE_SCENES = (APOLLO, "config - florida.txt", "config - sunset hurricane.txt")


def _golden_state(dev, bounce, tracking_k=4, options=None, scene=APOLLO):
    """The 32x18 golden frame's wavefront of ``scene`` (Apollo 11) just
    before ``bounce``, advanced there by the kernel path (at the TraceConfig
    ``options``)."""
    from digital_earth_tpu_torch.app.config_io import apply_config
    from digital_earth_tpu_torch.render import raygen
    from digital_earth_tpu_torch.render.renderer import Renderer

    cfg = TraceConfig(max_bounces=4, land_march_steps=64, max_tracking_steps=256,
                      tracking_k=tracking_k, **(options or {}))
    r = Renderer(dev, image_res=(32, 18), cfg=cfg,
                 atlas=build_atlas(generate_earth_textures((64, 128), seed=3), dev))
    apply_config(r, load_config(os.path.join(ROOT, "scenes", scene)))
    n = 32 * 18
    rays = raygen.gen_rays(r._seed_key, 0, 0, n, (32, 18), (1, 18), r.camera_params(), r.luts,
                           False, cfg=cfg)
    pos = r.camera_params().position.expand(n, 3).contiguous()
    st = pt.init_state(pos, rays.dirs, rays.wavelengths, rays.pdf, rays.keys)
    args = (r.scene_params(), r.atlas, r.luts, cfg)
    st = pt.run_bounces(st, *args, 0, bounce)
    return st, args


@pytest.mark.parametrize("bounce", [0, 3])
def test_bounce_kernel(dev, bounce):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import compact

    st, args = _golden_state(dev, bounce)
    idx, n_live = compact.compact_by_alive(st.alive, st.work_class)
    idx = idx[: int(n_live)]
    assert idx.numel() > 0
    want = pt.run_bounce_plain(st.take(idx.long()), bounce, *args)
    before = (kernels.bounce_flight.launches, kernels.bounce_shade.launches)
    pt.run_bounce(st, idx, bounce, *args)
    assert (kernels.bounce_flight.launches, kernels.bounce_shade.launches) == (
        before[0] + 1, before[1] + 1)
    assert _agreeing(st.take(idx.long()), want) >= 0.99


@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("tracking_k", [4, 6])
def test_bounce_kernel_bit_equal(dev, bounce, tracking_k):
    """bounce_flight + bounce_shade bit-equal to run_bounce_plain on every
    live lane, at the default tracking_k and at 6."""
    from digital_earth_tpu_torch.render import compact

    st, args = _golden_state(dev, bounce, tracking_k)
    idx, n_live = compact.compact_by_alive(st.alive, st.work_class)
    idx = idx[: int(n_live)]
    assert idx.numel() > 0
    want = pt.run_bounce_plain(st.take(idx.long()), bounce, *args)
    pt.run_bounce(st, idx, bounce, *args)
    got = st.take(idx.long())
    for name in ("pos", "direction", "throughput", "radiance", "w_mis"):
        assert _bits_equal(getattr(got, name), getattr(want, name)), name
    for name in ("alive", "primary_miss", "work_class"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


REFERENCE_OPTIONS = [
    dict(hero_lambdas=1), dict(analytic_transmittance=False),
    dict(hero_lambdas=1, stratify_spp=False, analytic_transmittance=False),
]


@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("options", REFERENCE_OPTIONS)
def test_bounce_kernel_bit_equal_at_the_reference_estimator(dev, bounce, options):
    """The bounce entries' instances at one wavelength and with the gases'
    sun transmittance by ratio tracking (and both) bit-equal to
    run_bounce_plain on every live lane; their census instances leave the
    timed instances' state and count the twin's trips, the NEE RMO site
    with the ratio tracking alone."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import compact

    st, args = _golden_state(dev, bounce, options=options)
    assert st.wavelength.shape[1] == options.get("hero_lambdas", 4)
    idx, n_live = compact.compact_by_alive(st.alive, st.work_class)
    idx = idx[: int(n_live)]
    assert idx.numel() > 0
    frame = pt.BounceFrame(st, *args)
    before, census = _clone_state(st), _clone_state(st)
    want = pt.run_bounce_plain(before.take(idx.long()), bounce, *args)
    pt.run_bounce(st, idx, bounce, *args, frame)
    got = st.take(idx.long())
    for name in ("pos", "direction", "throughput", "radiance", "w_mis"):
        assert _bits_equal(getattr(got, name), getattr(want, name)), name
    for name in ("alive", "primary_miss", "work_class"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    m = idx.numel()
    trips = torch.full((m, kernels.BOUNCE_SITES), -1, dtype=torch.int32, device=dev)
    cycles = torch.full((m, kernels.BOUNCE_CYCLE_COLS), -1, dtype=torch.int64, device=dev)
    ka = pt._kernel_args(census, idx, bounce, *args, frame)
    kernels.bounce_shade(*ka, flight=kernels.bounce_flight(*ka, trips=trips, cycles=cycles),
                         trips=trips, cycles=cycles)
    assert _same_state(st, census)
    plain = torch.zeros_like(trips)
    pt.run_bounce_plain(before.take(idx.long()), bounce, *args, trips=plain)
    assert int((trips != plain).any(1).sum()) <= 1
    ratio = not options.get("analytic_transmittance", True)
    assert (trips[:, 6].sum() > 0) == ratio
    assert (cycles[:, 4:7] <= cycles[:, 8:9]).all()


@pytest.mark.parametrize("options", REFERENCE_OPTIONS)
def test_bounce_window_kernel_bit_equal_at_the_reference_estimator(dev, options):
    """bounce_window's instances of the estimator from bounce 1 to the last
    against run_window_plain, every lane bit-equal."""
    st, args = _golden_state(dev, 1, options=options)
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    cfg = args[3]
    got, want = _clone_state(st), _clone_state(st)
    before = kernels_launches("bounce_window")
    pt.run_window(got, idx, 1, cfg.max_bounces, *args)
    assert kernels_launches("bounce_window") == before + 1
    pt.run_window_plain(want, idx, 1, cfg.max_bounces, *args)
    assert _same_state(got, want)


# The scene and march options (render/params.SCENE_OPTIONS): each alone, all
# seven off their defaults, and the five that act on land and clouds with
# land and clouds on; the reference estimator's (L, RATIO) sets with two
# options that act on land and clouds
MARCH_FIVE = dict(bilinear_tracking=True, lazy_march=False, march_exact_ocean=False,
                  march_ref_phantom=False, march_stall_patience=0)
SCENE_OPTION_CASES = [
    dict(enable_clouds=False), dict(enable_land=False), dict(bilinear_tracking=True),
    dict(lazy_march=False), dict(march_exact_ocean=False), dict(march_ref_phantom=False),
    dict(march_stall_patience=0), dict(enable_clouds=False, enable_land=False, **MARCH_FIVE),
    MARCH_FIVE,
] + [dict(lazy_march=False, bilinear_tracking=True, **o) for o in REFERENCE_OPTIONS]


def _options_launch(options) -> int:
    """1 if ``options`` runs the options instance (a flag off its default),
    else 0: every instance takes the stall patience."""
    return int(any(name != "march_stall_patience" for name in options))


def _bounce_both(st, idx, bounce, args, frame, **kw):
    """bounce_flight + bounce_shade on a copy of ``st`` (``kw`` to both)."""
    from digital_earth_tpu_torch import kernels

    got = _clone_state(st)
    ka = pt._kernel_args(got, idx, bounce, *args, frame)
    kernels.bounce_shade(*ka, flight=kernels.bounce_flight(*ka, **kw), **kw)
    return got


@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("options", SCENE_OPTION_CASES)
def test_bounce_options_instance_bit_equal(dev, bounce, options):
    """The bounce entries' options instances bit-equal to run_bounce_plain on
    every live lane at each option (the default instance at the stall
    patience alone); the census instance leaves the timed one's state and
    counts the twin's trips."""
    _hold_bounce_instance(dev, bounce, options)


def _hold_bounce_instance(dev, bounce, options, scene=APOLLO):
    """test_bounce_options_instance_bit_equal's checks on ``scene``."""
    from digital_earth_tpu_torch import kernels

    st, args = _golden_state(dev, bounce, options=options, scene=scene)
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    assert idx.numel() > 0
    frame = pt.BounceFrame(st, *args)
    before = kernels.bounce_flight.launches, kernels.bounce_flight.options_launches
    got = _bounce_both(st, idx, bounce, args, frame)
    assert (kernels.bounce_flight.launches, kernels.bounce_flight.options_launches) == (
        before[0] + 1, before[1] + _options_launch(options))
    want = pt.run_bounce_plain(st.take(idx.long()), bounce, *args)
    assert _same_state(got.take(idx.long()), want)
    m = idx.numel()
    trips = torch.full((m, kernels.BOUNCE_SITES), -1, dtype=torch.int32, device=dev)
    assert _same_state(_bounce_both(st, idx, bounce, args, frame, trips=trips), got)
    plain = torch.zeros_like(trips)
    pt.run_bounce_plain(st.take(idx.long()), bounce, *args, trips=plain)
    assert int((trips != plain).any(1).sum()) <= 1
    if not options.get("lazy_march", True):
        assert not bool(trips[:, 3].any())


@pytest.mark.parametrize("options", SCENE_OPTION_CASES)
def test_bounce_window_options_instance_bit_equal(dev, options):
    """bounce_window's options instances from bounce 1 to the last against
    run_window_plain, every lane bit-equal (the default instance at the
    stall patience alone)."""
    _hold_window_instance(dev, options)


def _hold_window_instance(dev, options, scene=APOLLO):
    """test_bounce_window_options_instance_bit_equal's checks on ``scene``."""
    from digital_earth_tpu_torch import kernels

    st, args = _golden_state(dev, 1, options=options, scene=scene)
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    got, want = _clone_state(st), _clone_state(st)
    before = kernels.bounce_window.launches, kernels.bounce_window.options_launches
    pt.run_window(got, idx, 1, args[3].max_bounces, *args)
    assert (kernels.bounce_window.launches, kernels.bounce_window.options_launches) == (
        before[0] + 1, before[1] + _options_launch(options))
    pt.run_window_plain(want, idx, 1, args[3].max_bounces, *args)
    assert _same_state(got, want)


@pytest.mark.parametrize("options", [{}] + REFERENCE_OPTIONS)
def test_bounce_options_instance_at_defaults_is_the_default(dev, options):
    """Each (L, RATIO) options instance, forced at the options' defaults,
    gives the default instance's bits: bounce_flight's outcome, the
    state after bounce_shade, and bounce_window's."""
    from digital_earth_tpu_torch import kernels

    for bounce in (0, 3):
        st, args = _golden_state(dev, bounce, options=options)
        idx, n_live = _live(st)
        idx = idx[: int(n_live)]
        frame = pt.BounceFrame(st, *args)
        ka = pt._kernel_args(st, idx, bounce, *args, frame)
        before = kernels.bounce_flight.options_launches
        assert torch.equal(kernels.bounce_flight(*ka, options=True).view(torch.int32),
                           kernels.bounce_flight(*ka).view(torch.int32))
        assert kernels.bounce_flight.options_launches == before + 1
        assert _same_state(_bounce_both(st, idx, bounce, args, frame, options=True),
                           _bounce_both(st, idx, bounce, args, frame))
        wins = []
        for forced in (True, False):
            w = _clone_state(st)
            kernels.bounce_window(*pt._kernel_args(w, idx, bounce, *args, frame),
                                  stop=args[3].max_bounces, options=forced)
            wins.append(w)
        assert _same_state(*wins)


MARCH_OPTION_CASES = [dict(bilinear_tracking=True), dict(march_exact_ocean=False),
                      dict(march_ref_phantom=False), dict(march_stall_patience=0),
                      dict(enable_land=False), MARCH_FIVE]


@pytest.mark.parametrize("options", MARCH_OPTION_CASES)
def test_land_march_options_instance(case, options):
    """land_march's options instance bit-equal to intersect_land_plain at
    each march option (the default instance at the stall patience alone),
    plain, any-hit and capped; forced at the defaults,
    bit-equal to the default instance."""
    from digital_earth_tpu_torch import kernels

    dev = case["pos"].device
    args = (case["atlas"].topography, case["pos"], case["dirs"],
            torch.tensor(7800.0, device=dev), case["active"], TraceConfig(**options))
    t_cap = torch.rand(N, device=dev) * 3e7 + 1e3
    for kw in (dict(), dict(any_hit=True), dict(t_cap=t_cap)):
        before = kernels.land_march.launches, kernels.land_march.options_launches
        got = tracers.intersect_land(*args, **kw)
        assert (kernels.land_march.launches, kernels.land_march.options_launches) == (
            before[0] + 1, before[1] + _options_launch(options))
        assert _bits_equal(got, tracers.intersect_land_plain(*args, **kw))
    step_floor, stall, _ = tracers._march_floor(args[0], TraceConfig())
    cap = torch.full((N,), float("inf"), device=dev)
    launch = lambda **o: kernels.land_march(  # noqa: E731
        args[0], args[1], args[2], args[4], cap, 7800.0, step_floor=step_floor,
        stall_thresh=stall, steps=250, k=4, patience=2, any_hit=False, **o)
    assert _bits_equal(launch(options=True), launch())


@pytest.mark.parametrize("mode", ["delta", "ratio"])
def test_cloud_track_bilinear_options_instance(case, mode):
    """cloud_track's options instance with bilinear taps against
    track_cloud_plain (the stated tolerances); forced at the defaults
    (nearest taps), bit-equal to the default instance."""
    from digital_earth_tpu_torch import kernels

    no_land = torch.full((N,), -1.0, device=case["pos"].device)
    cs, cm = pt.intersect_cloud_limits(case["pos"], case["dirs"], no_land)
    ext_w = torch.full((N,), C.CLOUDS_EXTINCT, device=case["pos"].device)
    args = (case["keys"], case["pos"], case["dirs"], cs, cm, ext_w, case["atlas"].clouds,
            case["active"], TraceConfig(bilinear_tracking=True), mode)
    before = kernels.cloud_track.options_launches
    got = tracers.track_cloud(*args)
    assert kernels.cloud_track.options_launches == before + 1
    want = tracers.track_cloud_plain(*args)
    if mode == "delta":
        assert (got[0] == want[0]).float().mean().item() >= 0.999
        same = (got[0] == want[0]) & (got[0] > 0)
        rel = ((got[1] - want[1]).abs() / want[1].clamp(min=1.0))[same]
        assert rel.median().item() < 1e-6
    else:
        assert abs(got.mean().item() - want.mean().item()) < 1e-4
    launch = lambda **o: kernels.cloud_track(  # noqa: E731
        case["keys"], case["pos"], case["dirs"], cs, cm, ext_w, case["active"],
        case["atlas"].clouds, max_steps=8192, k=4, ratio=mode == "ratio", **o)
    for a, b in zip(*(((x,) if mode == "ratio" else x) for x in (launch(options=True),
                                                                 launch()))):
        assert _bits_equal(a, b)


@pytest.mark.parametrize("options", MARCH_OPTION_CASES)
def test_preview_options_instance(dev, options):
    """preview's options instance bit-equal to march_paths_plain on every
    lane of a 160x90 frame at each march option (the default instance at
    the stall patience alone); forced at the defaults,
    bit-equal to the default instance."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raymarcher

    args, kw = _preview_lanes(dev, (160, 90), True)
    args = args[:7] + (TraceConfig(bilinear_materials=True, **options),)
    frame = raymarcher.PreviewFrame(*args[4:8], kw["tile"])
    key, pos, dirs, wl, _, atlas, luts, _ = args
    launch = lambda fr, **o: kernels.preview(  # noqa: E731
        fr.fparams, fr.iparams, key.tolist(), pos, dirs, wl, kw["tile_index"], kw["lane"],
        atlas.topography, atlas.material, atlas.stars, luts.o3_crossec, luts.srgb2spec, **o)
    before = kernels.preview.launches, kernels.preview.options_launches
    got = launch(frame)
    assert (kernels.preview.launches, kernels.preview.options_launches) == (
        before[0] + 1, before[1] + _options_launch(options))
    assert _bits_equal(got, raymarcher.march_paths_plain(*args, **kw))
    default = raymarcher.PreviewFrame(*args[4:7], TraceConfig(bilinear_materials=True),
                                      kw["tile"])
    assert _bits_equal(launch(default, options=True), launch(default))


def _agreeing(got, want):
    """The share of lanes with the twin's outcome and values (the bounce's
    stated tolerances)."""
    outcome = ((got.alive == want.alive) & (got.primary_miss == want.primary_miss)
               & (got.work_class == want.work_class))
    ok = outcome.clone()
    for name in ("pos", "throughput", "radiance", "w_mis"):
        g, w = getattr(got, name), getattr(want, name)
        atol = 1e-6 * w.abs().max().clamp(min=1e-30)
        ok &= ((g - w).abs() <= 1e-4 * w.abs() + atol).all(-1)
    ok &= ((got.direction - want.direction).abs() <= 1e-6).all(-1)
    return ok.float().mean().item()


def _clone_state(st):
    return pt.TraceState(**{k: v.clone() for k, v in vars(st).items()})


def _same_state(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in
               ("pos", "direction", "throughput", "radiance", "w_mis", "alive", "primary_miss",
                "work_class"))


def _live(st):
    from digital_earth_tpu_torch.render import compact

    idx, n_live = compact.compact_by_alive(st.alive, st.work_class)
    return idx, n_live


@pytest.mark.parametrize("bounce", [0, 3])
def test_bounce_census_matches_the_twins_loops(dev, bounce):
    """The census instances of bounce_flight and bounce_shade leave the
    timed instances' state and count the trips of the twin's plain loops,
    lane by lane: at most one lane may part (a loop and its twin parting on
    an ulp: 9 of 2.4M lanes at 1080p, chip_smoke.py's census; none expected
    in 576)."""
    from digital_earth_tpu_torch import kernels

    st, args = _golden_state(dev, bounce)
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    frame = pt.BounceFrame(st, *args)
    timed, census = _clone_state(st), _clone_state(st)
    pt.run_bounce(timed, idx, bounce, *args, frame)
    trips = torch.full((idx.numel(), kernels.BOUNCE_SITES), -1, dtype=torch.int32, device=dev)
    ka = pt._kernel_args(census, idx, bounce, *args, frame)
    kernels.bounce_shade(*ka, flight=kernels.bounce_flight(*ka, trips=trips), trips=trips)
    assert _same_state(timed, census)
    want = torch.zeros_like(trips)
    pt.run_bounce_plain(st.take(idx.long()), bounce, *args, trips=want)
    assert int((trips != want).any(1).sum()) <= 1
    assert trips[:, 1:3].sum() > 0


@pytest.mark.parametrize("bounce", [0, 3])
def test_bounce_clock_census_keeps_the_bits(dev, bounce):
    """The census instances with their clock64 columns leave the timed
    instances' state bit for bit and write each entry's cycles: each site's
    within its kernel's whole, the shade's surface branch (column 9) within
    the shade's, and only on the lanes that reach a surface (0 on the
    others)."""
    from digital_earth_tpu_torch import kernels

    st, args = _golden_state(dev, bounce)
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    frame = pt.BounceFrame(st, *args)
    timed, census = _clone_state(st), _clone_state(st)
    pt.run_bounce(timed, idx, bounce, *args, frame)
    m = idx.numel()
    trips = torch.full((m, kernels.BOUNCE_SITES), -1, dtype=torch.int32, device=dev)
    cycles = torch.full((m, kernels.BOUNCE_CYCLE_COLS), -1, dtype=torch.int64, device=dev)
    ka = pt._kernel_args(census, idx, bounce, *args, frame)
    flight = kernels.bounce_flight(*ka, trips=trips, cycles=cycles)
    kernels.bounce_shade(*ka, flight=flight, trips=trips, cycles=cycles)
    assert _same_state(timed, census)
    assert (cycles >= 0).all() and (cycles[:, 7:9] > 0).all()
    assert (cycles[:, :4] <= cycles[:, 7:8]).all() and (cycles[:, 4:7] <= cycles[:, 8:9]).all()
    assert (cycles[:, 9] <= cycles[:, 8]).all()
    outcome = flight[:, 2].view(torch.int32), flight[:, 1]
    surface = (outcome[0] == 0) & (outcome[1] > 0)
    assert bool(surface.any()) or bounce > 0
    assert (cycles[surface, 9] > 0).all()
    assert (cycles[~surface, 9] == 0).all()
    assert (cycles[:, 6] == 0).all() and (trips[:, 6] == 0).all()  # the closed form: no NEE RMO
    with pytest.raises(ValueError, match="trips"):
        kernels.bounce_flight(*ka, cycles=cycles)


def test_bounce_takes_the_live_count_from_the_device(dev):
    """With the count on the device the grid may hold more entries than live
    lanes (here the whole list, dead lanes after the live ones): the state
    is the one of the exact list."""
    from digital_earth_tpu_torch import kernels

    st, args = _golden_state(dev, 1)
    idx, n_live = _live(st)
    assert 0 < int(n_live) < idx.numel()
    frame = pt.BounceFrame(st, *args)
    exact, counted = _clone_state(st), _clone_state(st)
    pt.run_bounce(exact, idx[: int(n_live)], 1, *args, frame)
    before = kernels.bounce_flight.launches
    ka = pt._kernel_args(counted, idx, 1, *args, frame)
    kernels.bounce_shade(*ka, flight=kernels.bounce_flight(*ka, n_live=n_live), n_live=n_live)
    assert kernels.bounce_flight.launches == before + 1
    assert _same_state(exact, counted)
    window = _clone_state(st)
    pt.run_window(window, idx, 1, 2, *args, frame, n_live)
    assert _same_state(exact, window)


def test_bounce_window_kernel(dev):
    """bounce_window from bounce 1 to the last against run_window_plain, lane
    by lane (the bounce's stated tolerances)."""
    st, args = _golden_state(dev, 1)
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    cfg = args[3]
    got, want = _clone_state(st), _clone_state(st)
    before = kernels_launches("bounce_window")
    pt.run_window(got, idx, 1, cfg.max_bounces, *args)
    assert kernels_launches("bounce_window") == before + 1
    pt.run_window_plain(want, idx, 1, cfg.max_bounces, *args)
    lanes = idx.long()
    assert _agreeing(got.take(lanes), want.take(lanes)) >= 0.99


def kernels_launches(name):
    from digital_earth_tpu_torch import kernels

    return kernels.launch_counts()[name]


def test_windowed_frame_matches_per_bounce_frame(dev):
    """A 256x144 Apollo spp with the window (the frame's 36,864 lanes under
    the threshold, 50,688 on an H100: one window launch from bounce 0) and
    with one launch per bounce: the same buffer bit for bit."""
    import functools

    from digital_earth_tpu_torch import kernels

    run_bounces = pt.run_bounces
    bufs = []
    assert 256 * 144 < kernels.window_threshold(dev)
    for window_at in (0, None):
        r = _apollo_renderer(dev, (256, 144), "path")
        pt.run_bounces = functools.partial(run_bounces, window_at=window_at)
        try:
            kernels.reset_launch_counts()
            r.accumulate()
        finally:
            pt.run_bounces = run_bounces
        bufs.append(r.color_buffer)
        counts = kernels.launch_counts()
        if window_at == 0:
            assert counts["bounce_window"] == 0 and counts["bounce_flight"] > 0
        else:
            assert counts["bounce_window"] == 1 and counts["bounce_flight"] == 0
    assert torch.equal(*bufs)


@pytest.mark.parametrize("case", ["empty", "all_dead", "all_alive", "mixed", "frame"])
def test_compact_lanes_kernel(dev, case):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import compact

    g = torch.Generator().manual_seed(7)
    n = {"empty": 0, "frame": 1920 * 1080}.get(case, 4099)
    alive = torch.rand(n, generator=g) < 0.4
    if case == "all_dead":
        alive[:] = False
    elif case == "all_alive":
        alive[:] = True
    wc = torch.randint(-1, 5, (n,), generator=g, dtype=torch.int32)
    alive, wc = alive.to(dev), wc.to(dev)
    before = kernels.compact_lanes.launches
    idx, n_live = compact.compact_by_alive(alive, wc)
    assert kernels.compact_lanes.launches == before + 1
    want, want_n = compact.compact_by_alive_plain(alive, wc)
    m = int(want_n)
    assert int(n_live) == m == int(alive.sum())
    assert torch.equal(idx[:m], want[:m])


def test_density_check_kernel(case):
    from digital_earth_tpu_torch.models import atmosphere_lut as atm

    pos, d = case["pos"], case["dirs"]
    g = torch.Generator().manual_seed(8)
    t0 = (torch.rand(N, generator=g) * 1e5).to(pos.device)
    t1 = t0 + (torch.rand(N, generator=g) * 3e5).to(pos.device)
    ext = (torch.rand((N, 4, 3), generator=g) * 3e-5).to(pos.device)
    seg, trans = atm.density_check(pos, d, t0, t1, ext)
    want_seg = atm.density_integral_segment(pos, d, t0, t1)
    want_trans = atm.rmo_transmittance_to_space(ext, pos, d)
    for got, want in ((seg, want_seg), (trans, want_trans)):
        atol = 1e-6 * want.abs().max()
        close = ((got - want).abs() <= 1e-4 * want.abs() + atol).all(-1)
        assert close.float().mean().item() >= 0.999


def test_bounce_launchers_check_their_inputs(case):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.models import atmosphere_lut as atm

    dev = case["pos"].device
    alive = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        kernels.compact_lanes(alive, torch.zeros(8, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="shape"):
        kernels.compact_lanes(alive, torch.zeros(4, dtype=torch.int32, device=dev))
    pos = case["pos"][:8].contiguous()
    z = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="shape"):
        kernels.density_check(pos, pos, z, z, torch.zeros((8, 3, 3), device=dev),
                              atm.density_table(dev))
    st, args = _golden_state(dev, 0)
    frame = pt.BounceFrame(st, *args)
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    fields = [st.pos, st.direction, st.wavelength, st.lambda_pdf, st.throughput, st.radiance,
              st.w_mis, st.alive, st.primary_miss, st.work_class, frame.keys]
    iparams = list(frame.iparams)
    with pytest.raises(ValueError, match="dtype"):
        kernels.bounce_flight(frame.fparams, iparams, *fields, idx.long(), *frame.tables)
    # a block whose packet is not the state's, and a packet of no wavelength
    with pytest.raises(ValueError, match="shape"):
        kernels.bounce_flight(frame.fparams, [3] + iparams[1:], *fields, idx, *frame.tables)
    with pytest.raises(ValueError, match="wavelengths"):
        kernels.bounce_flight(frame.fparams, [0] + iparams[1:], *fields, idx, *frame.tables)
    with pytest.raises(ValueError, match="contiguous"):
        bad = list(fields)
        bad[0] = st.direction.t().contiguous().t()
        kernels.bounce_flight(frame.fparams, iparams, *bad, idx, *frame.tables)
    # lane ids outside the state are skipped, the rest advance as without them
    n = st.alive.numel()
    outside = torch.tensor([n + 5, -3], dtype=torch.int32, device=dev)
    runs = []
    for ids in (idx, torch.cat([idx, outside])):
        s2 = pt.TraceState(**{k: v.clone() for k, v in vars(st).items()})
        pt.run_bounce(s2, ids, 0, *args, frame)
        runs.append(s2)
    for name in ("pos", "direction", "throughput", "radiance", "w_mis", "alive", "work_class"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name)), name
    ka = pt._kernel_args(st, idx, 0, *args, frame)
    with pytest.raises(ValueError, match="dtype"):
        kernels.bounce_flight(*ka, n_live=torch.ones(1, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="shape"):
        kernels.bounce_flight(*ka, trips=torch.zeros((8, 5), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="dtype"):
        kernels.bounce_shade(*ka, flight=torch.zeros((8, 4), device=dev),
                             trips=torch.zeros((8, 6), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="shape"):
        kernels.bounce_flight(*ka, n_live=torch.ones(2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="shape"):
        kernels.bounce_shade(*ka, flight=torch.zeros((4, 4), device=dev))
    with pytest.raises(ValueError, match="dtype"):
        kernels.bounce_window(*ka[:13], idx.long(), *ka[14:], stop=3)


def _edge_points(h, w, device="cpu"):
    """chip_smoke.py's tap_edge_points: the points at which the taps of an
    (h, w) texture are held at their edges, on the CPU and on the card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.tap_edge_points(torch, h, w, device=device)


def _hold_tap(got, want, points=None, first=None):
    """A tap finite and within 1e-5 of its twin (the same op-by-op rounding;
    chip_smoke.py TAP_ATOL) on every row; with ``points`` (the edge sweep)
    on every row whose point has no NaN or infinite component (there the
    kernel's fminf and fmaxf take a NaN as missing and torch.clamp keeps
    it, so the two may tap other texels: ROADMAP C #8). With ``first`` (the
    first bilinear form's tap) bit for bit on every row, NaN payloads
    included. Returns the rows bit-equal to the twin (a NaN equal to a
    NaN)."""
    assert got.shape == want.shape
    held = slice(None) if points is None else points.isfinite().all(-1)
    g, w = got[held], want[held]
    assert g.shape[0] > 0
    assert bool(g.isfinite().all()) and bool(w.isfinite().all())
    assert (g - w).abs().max().item() <= 1e-5
    if first is not None:
        assert torch.equal(got.view(torch.int32), first.view(torch.int32))
    return ((got == want) | (got.isnan() & want.isnan())).all(-1)


@pytest.mark.parametrize("bilinear", [True, False])
def test_sphere_tap_kernel(case, bilinear):
    """The bounce's material (8-channel) and topography (4-channel) taps
    against ops/texture.sample_sphere_texture at the case's points (every
    row finite and within 1e-5) and on the edge sweep
    (chip_smoke.tap_edge_points: u at 0 and 1, the seam, the poles and
    clamped rows, zero-length, NaN and infinite points; the same at the
    points of finite components), the bilinear tap bit for bit against the
    form texture.cuh first had on every point, and at least as often
    bit-equal to the twin as that form."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import texture as tx

    for tex in (case["atlas"].material, case["atlas"].topography):
        sweep = _edge_points(*tex.shape[:2], device=tex.device)
        for pos, points in ((case["pos"], None), (sweep, sweep)):
            got = kernels.sphere_tap(tex, pos, bilinear)
            want = tx.sample_sphere_texture(tex, pos, bilinear=bilinear)
            first = kernels.sphere_tap(tex, pos, True, first_form=True) if bilinear else None
            same = _hold_tap(got, want, points, first)
            if bilinear:
                assert same.sum() >= _hold_tap(first, want, points).sum()


@pytest.mark.parametrize("bilinear", [True, False])
def test_dir_tap_kernel(case, bilinear):
    """The stars' 3-channel direction tap (texture.cuh dir_tap, as frame_end
    and preview take it) against ops/texture.sample_dir_texture at the
    case's directions and on the edge sweep: as test_sphere_tap_kernel
    holds the sphere taps."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import texture as tx

    stars = case["atlas"].stars
    sweep = _edge_points(*stars.shape[:2], device=stars.device)
    for d, points in ((case["dirs"], None), (sweep, sweep)):
        got = kernels.dir_tap(stars, d, bilinear)
        want = tx.sample_dir_texture(stars, d, bilinear=bilinear)
        first = kernels.dir_tap(stars, d, True, first_form=True) if bilinear else None
        same = _hold_tap(got, want, points, first)
        if bilinear:
            assert same.sum() >= _hold_tap(first, want, points).sum()


@pytest.mark.parametrize("shape,factor,jitter,channel,seed", [
    ((7, 13, 3), 5, 0.0, 0, 0), ((7, 13, 3), 5, 0.06, 0, 0xC10D),
    ((9, 11, 4), 8, 0.06, 0, 0x7071), ((9, 11, 4), 1, 0.06, 0, 0x7071),
    ((5, 17, 8), 3, 0.0, 0, 0), ((5, 17, 8), 3, 0.5, 6, 0x9E3779B9),
    ((135, 270, 8), 8, 0.06, 0, 0x7071), ((3, 5), 4, 0.06, 0, 0x7071),
])
def test_upsample_kernel(dev, shape, factor, jitter, channel, seed):
    """upsample (csrc/upsample.cu) bit-equal to ops/texture.upsample_plain
    on odd shapes, C = 1/3/4/8, factor 1, with and without the jitter."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import texture as tx

    img = torch.from_numpy(np.random.default_rng(sum(shape) + factor).integers(
        0, 256, shape, dtype=np.uint8)).to(dev)
    before = kernels.upsample.launches
    got = tx.upsample(img, factor, jitter, channel, seed)
    want = tx.upsample_plain(img, factor, jitter, channel, seed)
    torch.cuda.synchronize()
    assert kernels.upsample.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("f", [1, 2, 8])
@pytest.mark.parametrize("c", range(1, 9))
def test_upsample_kernel_odd_rows(dev, c, f):
    """Rows of W C bytes off a multiple of 16 (the byte path: w = 7 or 9 with
    C odd or f = 1, 2) and on it (the vector path), jittering channel c - 1,
    bit-equal to the twin."""
    from digital_earth_tpu_torch.ops import texture as tx

    for w in (7, 9):
        img = torch.from_numpy(np.random.default_rng(8 * c + f + w).integers(
            0, 256, (5, w, c), dtype=np.uint8)).to(dev)
        for jitter in (0.0, 0.3):
            got = tx.upsample(img, f, jitter, c - 1, 0x7071)
            want = tx.upsample_plain(img, f, jitter, c - 1, 0x7071)
            assert torch.equal(got, want), (w, jitter)


@pytest.mark.parametrize("c,jc", [(8, j) for j in range(8)] + [(4, j) for j in range(4)]
                         + [(3, j) for j in range(3)])
def test_upsample_kernel_tier2_widths(dev, c, jc):
    """The tier-2 planes' widths (2700 base texels upsampled 8x to 21600) at
    16 output rows, the jitter on each channel in turn."""
    from digital_earth_tpu_torch.ops import texture as tx

    img = torch.from_numpy(np.random.default_rng(10 * c + jc).integers(
        0, 256, (2, 2700, c), dtype=np.uint8)).to(dev)
    got = tx.upsample(img, 8, 0.06, jc, 0xC10D)
    want = tx.upsample_plain(img, 8, 0.06, jc, 0xC10D)
    assert got.shape == (16, 21600, c) and torch.equal(got, want)


def test_upsample_launcher_checks_its_inputs(dev):
    from digital_earth_tpu_torch import kernels

    img = torch.zeros((4, 6, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        kernels.upsample(img.float(), 2, 0.0, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.upsample(img.cpu(), 2, 0.0, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.upsample(img[:, ::2], 2, 0.0, 0, 0)
    with pytest.raises(ValueError, match="channels"):
        kernels.upsample(torch.zeros((4, 6, 9), dtype=torch.uint8, device=dev), 2, 0.0, 0, 0)


# The naive arm (render/params.NAIVE_OPTIONS): each flag alone, and two of
# them with options that act on the same loops
NAIVE_OPTION_CASES = [
    dict(naive_tracking=True, hero_lambdas=1), dict(naive_march=True),
    dict(naive_cloud_tracking=True), dict(naive_shadow=True),
    dict(naive_tracking=True, hero_lambdas=1, analytic_transmittance=False,
         bilinear_tracking=True),
    dict(naive_march=True, naive_cloud_tracking=True, bilinear_tracking=True),
]


@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("options", NAIVE_OPTION_CASES)
def test_bounce_options_instance_bit_equal_at_naive_flags(dev, bounce, options):
    """The bounce entries' options instances at the naive flags, as
    test_bounce_options_instance_bit_equal holds the scene options."""
    test_bounce_options_instance_bit_equal(dev, bounce, options)


@pytest.mark.parametrize("options", NAIVE_OPTION_CASES)
def test_bounce_window_options_instance_bit_equal_at_naive_flags(dev, options):
    test_bounce_window_options_instance_bit_equal(dev, options)


def test_bounce_refuses_naive_tracking_at_four_wavelengths(dev):
    """The naive trackers are single-wavelength: the wrappers refuse a
    bounce launch at naive_tracking with four wavelengths a lane."""
    from digital_earth_tpu_torch import kernels

    st, args = _golden_state(dev, 0)
    idx, n_live = _live(st)
    frame = pt.BounceFrame(st, *args)
    ka = list(pt._kernel_args(st, idx[: int(n_live)], 0, *args, frame))
    ka[1] = list(ka[1])
    ka[1][16 + kernels.BOUNCE_OPTIONS.index("naive_tracking")] = 1
    with pytest.raises(ValueError, match="naive_tracking"):
        kernels.bounce_flight(*ka)


@pytest.mark.parametrize("fn,species", [("intersect_land_naive", None),
                                        ("delta_track_naive", "rmo"),
                                        ("delta_track_naive", "cloud"),
                                        ("ratio_track_naive", "rmo"),
                                        ("ratio_track_naive", "cloud")])
@pytest.mark.parametrize("bilinear", [False, True])
def test_naive_launchers_bit_equal(dev, case, fn, species, bilinear):
    """The naive launchers against their plain twins on the case's lanes:
    every output bit-equal, each lane's steps the twin's."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import tracking_naive as tn

    cfg = TraceConfig(bilinear_tracking=bilinear, max_tracking_steps=2048)
    topo, clouds = case["atlas"].topography, case["atlas"].clouds
    pos, dirs, active = case["pos"], case["dirs"], case["active"]
    trips = torch.zeros(N, dtype=torch.int32, device=dev)
    if species is None:
        want = tn.intersect_land_naive_plain(topo, pos, dirs, 7800.0, active, cfg, trips=trips)
        got, steps = kernels.naive_march(topo, pos, dirs, active, 7800.0,
                                         steps=cfg.land_march_steps, bilinear=bilinear,
                                         iters=True)
        got, want = (got,), (want,)
    else:
        no_land = torch.full((N,), -1.0, device=dev)
        if species == "rmo":
            t0, t1 = pt._rmo_span(pos, dirs, no_land)
            ext = torch.cat([case["ext_h"], torch.zeros((N, 1), device=dev)], dim=-1)
            max_ext = vol.max_extinction_rmo(case["ext"][:, :1, :])
        else:
            t0, t1 = pt.intersect_cloud_limits(pos, dirs, no_land)
            ext = torch.zeros((N, 4), device=dev)
            ext[:, 3] = C.CLOUDS_EXTINCT
            max_ext = torch.full((N,), C.CLOUDS_EXTINCT, device=dev) * C.CLOUDS_DENSITY
        args = (case["keys"], pos, dirs, t0, t1, ext, max_ext, clouds, species, active, cfg)
        want = getattr(tn, f"{fn}_plain")(*args, trips=trips)
        launcher = kernels.naive_delta_track if fn == "delta_track_naive" else \
            kernels.naive_ratio_track
        before = launcher.launches
        got, steps = launcher(case["keys"], pos, dirs, t0, t1, ext, max_ext, active, clouds,
                              species=species, max_steps=cfg.max_tracking_steps,
                              bilinear=bilinear, iters=True)
        assert launcher.launches == before + 1
        assert torch.equal(getattr(tn, fn)(*args)[0] if fn == "delta_track_naive"
                           else getattr(tn, fn)(*args), got[0] if fn == "delta_track_naive"
                           else got)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
    assert torch.equal(steps, trips) and int(trips.max()) > 1


# The trackers' warp-cooperative steps (csrc/naive.cuh naive_track_warp) on
# the edges of their rounds: delta tracking of both species and the cloud's
# ratio tracking (the gases' is one thread a lane)
NAIVE_TRACKERS = [("delta_track_naive", "rmo"), ("delta_track_naive", "cloud"),
                  ("ratio_track_naive", "cloud")]
NAIVE_EDGE_WARPS = 256


def _naive_tracker_args(dev, case, species, max_steps=2048, thick=1.0):
    """A tracker call's twin arguments on the case's lanes (as
    test_naive_launchers_bit_equal makes them), the majorant ``thick`` times
    the global one."""
    cfg = TraceConfig(max_tracking_steps=max_steps)
    pos, dirs = case["pos"], case["dirs"]
    no_land = torch.full((N,), -1.0, device=dev)
    if species == "rmo":
        t0, t1 = pt._rmo_span(pos, dirs, no_land)
        ext = torch.cat([case["ext_h"], torch.zeros((N, 1), device=dev)], dim=-1)
        max_ext = vol.max_extinction_rmo(case["ext"][:, :1, :])
    else:
        t0, t1 = pt.intersect_cloud_limits(pos, dirs, no_land)
        ext = torch.zeros((N, 4), device=dev)
        ext[:, 3] = C.CLOUDS_EXTINCT
        max_ext = torch.full((N,), C.CLOUDS_EXTINCT, device=dev) * C.CLOUDS_DENSITY
    return [case["keys"], pos, dirs, t0, t1, ext, max_ext * thick, case["atlas"].clouds, species,
            case["active"], cfg]


def _naive_span_lanes(args):
    """The lanes of a tracker call that track (active, with a span)."""
    return torch.nonzero(args[9] & (args[4] >= 0.0) & (args[3] < args[4])).squeeze(1)


def _naive_take(args, idx, one_a_warp=False):
    """A tracker call's arguments at the lanes ``idx``; with ``one_a_warp``
    each lane heads a warp of 32 copies of itself, the other 31 inactive."""
    if one_a_warp:
        idx = torch.repeat_interleave(idx, 32)
    out = [a[idx] if i not in (7, 8, 10) else a for i, a in enumerate(args)]
    if one_a_warp:
        out[9] = torch.zeros_like(out[9])
        out[9][::32] = True
    return out


def _hold_naive_tracker(fn, args):
    """The tracker's launcher against its twin: every output bit-equal,
    each lane's steps the twin's; the steps."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import tracking_naive as tn

    keys, pos, dirs, t0, t1, ext, max_ext, clouds, species, active, cfg = args
    trips = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    want = getattr(tn, f"{fn}_plain")(*args, trips=trips)
    launcher = kernels.naive_delta_track if fn == "delta_track_naive" else \
        kernels.naive_ratio_track
    got, steps = launcher(keys, pos, dirs, t0, t1, ext, max_ext, active, clouds, species=species,
                          max_steps=cfg.max_tracking_steps, iters=True)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
    assert torch.equal(steps, trips)
    return trips


@pytest.mark.parametrize("fn,species", NAIVE_TRACKERS)
def test_naive_tracker_one_lane_a_warp(dev, case, fn, species):
    """One tracking lane a warp: each round the lane takes all 32 threads."""
    args = _naive_tracker_args(dev, case, species)
    lanes = _naive_span_lanes(args)[:NAIVE_EDGE_WARPS]
    trips = _hold_naive_tracker(fn, _naive_take(args, lanes, one_a_warp=True))
    assert int((trips > 0).sum()) == lanes.numel() and int(trips.max()) > 1


@pytest.mark.parametrize("fn,species", NAIVE_TRACKERS)
def test_naive_tracker_full_warps(dev, case, fn, species):
    """Every lane of every warp tracking: the first rounds one thread a
    lane, the groups growing as lanes stop."""
    args = _naive_tracker_args(dev, case, species)
    lanes = _naive_span_lanes(args)[: 32 * NAIVE_EDGE_WARPS]
    trips = _hold_naive_tracker(fn, _naive_take(args, lanes))
    assert bool((trips > 0).all())


@pytest.mark.parametrize("fn,species", NAIVE_TRACKERS)
@pytest.mark.parametrize("max_steps", [1, 7, 33])
def test_naive_tracker_step_cap_inside_a_round(dev, case, fn, species, max_steps):
    """max_tracking_steps 1, 7 and 33, which end a lane inside a round of
    2 to 32 threads."""
    args = _naive_tracker_args(dev, case, species, max_steps=max_steps)
    lanes = _naive_span_lanes(args)
    for one in (False, True):
        take = lanes[:NAIVE_EDGE_WARPS] if one else lanes[: 32 * NAIVE_EDGE_WARPS]
        trips = _hold_naive_tracker(fn, _naive_take(args, take, one_a_warp=one))
        assert bool((trips == max_steps).any()) and int(trips.max()) == max_steps


@pytest.mark.parametrize("fn,species", NAIVE_TRACKERS)
def test_naive_tracker_stop_on_a_rounds_last_thread(dev, case, fn, species):
    """One lane a warp whose twin stops after a multiple of 32 steps (at
    four times the global majorant, whose null steps lengthen the tracks),
    so that its stop falls on its last round's last thread."""
    from digital_earth_tpu_torch.render import tracking_naive as tn

    args = _naive_tracker_args(dev, case, species, thick=4.0)
    lanes = _naive_span_lanes(args)
    trips = torch.zeros(lanes.numel(), dtype=torch.int32, device=dev)
    getattr(tn, f"{fn}_plain")(*_naive_take(args, lanes), trips=trips)
    stops = lanes[(trips % 32 == 0) & (trips > 0)
                  & (trips < args[10].max_tracking_steps)][:NAIVE_EDGE_WARPS]
    assert stops.numel() >= 8
    got = _hold_naive_tracker(fn, _naive_take(args, stops, one_a_warp=True))
    got = got[got > 0]
    assert got.numel() == stops.numel() and bool((got % 32 == 0).all())


# The naive march's block rounds (csrc/naive.cuh naive_march_block: a block's
# lanes still marching repacked onto its first threads between rounds of
# steps) on their edges
MARCH_BLOCK = 128


def _hold_naive_march(topo, pos, dirs, active, cfg, scale=7800.0):
    """The march's launcher against intersect_land_naive_plain: every
    distance bit-equal, each lane's steps the twin's; (distances, steps)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import tracking_naive as tn

    trips = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    want = tn.intersect_land_naive_plain(topo, pos, dirs, scale, active, cfg, trips=trips)
    before = kernels.naive_march.launches
    got, steps = kernels.naive_march(topo, pos, dirs, active, scale, steps=cfg.land_march_steps,
                                     enable=cfg.enable_land, bilinear=cfg.bilinear_tracking,
                                     iters=True)
    assert kernels.naive_march.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(steps, trips)
    return want, trips


@pytest.mark.parametrize("steps", [1, 7, 250])
@pytest.mark.parametrize("bilinear", [False, True])
def test_naive_march_every_lane_marching(dev, case, steps, bilinear):
    """Every lane of every block marching, at land_march_steps 1, 7 and
    250, nearest and bilinear taps."""
    cfg = TraceConfig(land_march_steps=steps, bilinear_tracking=bilinear)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    _, trips = _hold_naive_march(case["atlas"].topography, case["pos"], case["dirs"], active, cfg)
    assert bool((trips > 0).all()) and int(trips.max()) == steps


@pytest.mark.parametrize("steps", [7, 250])
@pytest.mark.parametrize("thread", [0, 77, 127])
def test_naive_march_one_lane_a_block(dev, case, steps, thread):
    """One marching lane a block, on its first, a middle or its last
    thread: each round it moves to the block's first thread."""
    cfg = TraceConfig(land_march_steps=steps)
    active = torch.zeros(N, dtype=torch.bool, device=dev)
    active[thread::MARCH_BLOCK] = True
    _, trips = _hold_naive_march(case["atlas"].topography, case["pos"], case["dirs"], active, cfg)
    assert int((trips > 0).sum()) == N // MARCH_BLOCK and int(trips.max()) > 1


def test_naive_march_hit_at_the_budget(dev, case):
    """Lanes that stop at the step budget short of ten planet radii hit
    there (the reference's hit at the budget), beside lanes that stop before
    it."""
    cfg = TraceConfig(land_march_steps=7)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    t, trips = _hold_naive_march(case["atlas"].topography, case["pos"], case["dirs"], active, cfg)
    assert bool(((trips == 7) & (t >= 0.0)).any()) and bool((trips < 7).any())


def test_naive_march_under_the_surface(dev, case):
    """Rays that start under the terrain (a negative SDF: the first step
    goes back along the ray), every lane marching to the budget or a stop."""
    r = np.random.default_rng(11)
    v = r.normal(size=(N, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = torch.tensor(v * (C.PLANET_R - 500.0), dtype=torch.float32, device=dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    _, trips = _hold_naive_march(case["atlas"].topography, pos, case["dirs"], active,
                                 TraceConfig())
    assert int(trips.max()) > 1


def test_naive_march_without_land_and_inactive_lanes(dev, case):
    """enable_land False: every lane a miss with no step; a random half of
    the lanes inactive: those a miss with no step, the others as the twin."""
    topo, pos, dirs = case["atlas"].topography, case["pos"], case["dirs"]
    active = torch.ones(N, dtype=torch.bool, device=dev)
    t, trips = _hold_naive_march(topo, pos, dirs, active, TraceConfig(enable_land=False))
    assert bool((t == -1.0).all()) and not bool(trips.any())
    half = torch.from_numpy(np.random.default_rng(12).random(N) < 0.5).to(dev)
    t, trips = _hold_naive_march(topo, pos, dirs, half, TraceConfig())
    assert bool((t[~half] == -1.0).all()) and not bool(trips[~half].any())
    assert bool((trips[half] > 0).all())


@pytest.mark.parametrize("n", [77, MARCH_BLOCK + 1, N - 77])
def test_naive_march_last_partial_block(dev, case, n):
    """A last block of fewer lanes than threads (one block short of a
    block, one lane past a block, a frame's worth with 51 lanes in its last
    block): its threads past the lanes take part in the rounds, inactive."""
    active = case["active"][:n].clone()
    active[:3] = True
    _hold_naive_march(case["atlas"].topography, case["pos"][:n].contiguous(),
                      case["dirs"][:n].contiguous(), active, TraceConfig())


# The estimator options (render/params.ESTIMATOR_OPTIONS): each alone (the
# roulettes' start bounces set so that they act at bounces 0 and 3), all
# but nee_off, and with the reference's estimator, marching first and
# beside naive_tracking
ESTIMATOR_OPTION_CASES = [
    dict(analytic_flight=True), dict(analytic_flight=True, flight_newton_iters=3),
    dict(fast_loop_rng=True), dict(nee_rr_prob=0.5, nee_rr_start=-1),
    dict(cloud_rr_keep=0.5, cloud_rr_start=0), dict(nee_off=True),
    dict(analytic_flight=True, fast_loop_rng=True, nee_rr_prob=0.3, nee_rr_start=-1,
         cloud_rr_keep=0.7, cloud_rr_start=0),
    dict(analytic_flight=True, fast_loop_rng=True, hero_lambdas=1, stratify_spp=False,
         analytic_transmittance=False),
    dict(analytic_flight=True, lazy_march=False),
    dict(fast_loop_rng=True, naive_tracking=True, hero_lambdas=1),
]


@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("options", ESTIMATOR_OPTION_CASES)
def test_bounce_options_instance_bit_equal_at_estimator_options(dev, bounce, options):
    """The bounce entries' options instances at the estimator options, as
    test_bounce_options_instance_bit_equal holds the scene options (the
    census's RMO column at analytic_flight its Newton steps)."""
    test_bounce_options_instance_bit_equal(dev, bounce, options)


@pytest.mark.parametrize("options", ESTIMATOR_OPTION_CASES)
def test_bounce_window_options_instance_bit_equal_at_estimator_options(dev, options):
    test_bounce_window_options_instance_bit_equal(dev, options)


@pytest.mark.parametrize("n_iter", [0, 1, 14, 30])
def test_flight_analytic_launcher_bit_equal(dev, case, n_iter):
    """flight_analytic against sample_rmo_flight_analytic_plain on the
    case's lanes over their spans to the land-free top of the atmosphere:
    event, distance and interaction id bit-equal, each lane's steps the
    twin's census count."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.models import atmosphere_lut as atm

    pos, dirs, active = case["pos"], case["dirs"], case["active"]
    t0, t1 = pt._rmo_span(pos, dirs, torch.full((N,), -1.0, device=dev))
    cfg = TraceConfig(analytic_flight=True, flight_newton_iters=n_iter)
    trips = torch.zeros(N, dtype=torch.int32, device=dev)
    want = tracers.sample_rmo_flight_analytic_plain(case["keys"], pos, dirs, t0, t1,
                                                    case["ext_h"], active, cfg, trips=trips)
    before = kernels.flight_analytic.launches
    got, steps = kernels.flight_analytic(case["keys"], pos, dirs, t0, t1, case["ext_h"], active,
                                         atm.density_table(dev), n_iter=n_iter, iters=True)
    assert kernels.flight_analytic.launches == before + 1
    assert all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
    assert torch.equal(steps, trips)
    assert bool((want[0] > 0).any()) and bool((want[0] == 0).any())
    wrapped = tracers.sample_rmo_flight_analytic(case["keys"], pos, dirs, t0, t1, case["ext_h"],
                                                 active, cfg)
    assert all(torch.equal(g, w) for g, w in zip(wrapped, want))


@pytest.mark.parametrize("counter", [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 2**32 + 5])
def test_fast_uniform_check_bit_equal(dev, counter):
    """fast_uniform_check against ops/rng.fast_uniform on edge keys and
    random keys, 12 words a lane: every bit."""
    from digital_earth_tpu_torch import kernels

    keys = rng.lane_keys(rng.prng_key(3, dev), torch.arange(4096, device=dev))
    keys[:6] = torch.tensor([[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], [0x80000000, 1],
                             [1, 0x80000000], [0xFFFFFFFF, 0], [0, 0xFFFFFFFF]], device=dev)
    got = kernels.fast_uniform_check(keys, counter, 12)
    want = rng.fast_uniform(keys, counter, (12,))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("tracker", ["rmo_delta", "rmo_ratio_1", "rmo_ratio_4", "cloud_delta",
                                     "cloud_ratio"])
def test_tracker_launchers_bit_equal_at_fast_loop_rng(dev, case, tracker):
    """The tracker launchers' options instances at fast_loop_rng against
    their twins at it on the case's lanes: every output bit-equal; their
    draws are not threefry's (the default instance's outputs differ)."""
    from digital_earth_tpu_torch import kernels

    cfg = TraceConfig(fast_loop_rng=True, max_tracking_steps=2048)
    threefry = TraceConfig(max_tracking_steps=2048)
    pos, dirs, active = case["pos"], case["dirs"], case["active"]
    no_land = torch.full((N,), -1.0, device=dev)
    if tracker.startswith("rmo"):
        t0, t1 = pt._rmo_span(pos, dirs, no_land)
    else:
        t0, t1 = pt.intersect_cloud_limits(pos, dirs, no_land)
    if tracker == "rmo_delta":
        args = (case["keys"], pos, dirs, t0, t1, case["ext_h"], active)
        launcher = kernels.rmo_delta_track
        run = lambda c: tracers.delta_track_rmo(*args, c)  # noqa: E731
        want = tracers.delta_track_rmo_plain(*args, cfg)
    elif tracker.startswith("rmo_ratio"):
        ext = case["ext"][:, :int(tracker[-1])].contiguous()
        args = (case["keys"], pos, dirs, t0, t1, ext, vol.max_extinction_rmo(ext), active)
        launcher = kernels.rmo_ratio_track
        run = lambda c: (tracers.ratio_track_rmo(*args, c),)  # noqa: E731
        want = (tracers.ratio_track_rmo_plain(*args, cfg),)
    else:
        mode = tracker.split("_")[1]
        ext_w = torch.full((N,), C.CLOUDS_EXTINCT, device=dev)
        args = (case["keys"], pos, dirs, t0, t1, ext_w, case["atlas"].clouds, active)
        launcher = kernels.cloud_track
        wrap = (lambda x: (x,)) if mode == "ratio" else tuple
        run = lambda c: wrap(tracers.track_cloud(*args, c, mode))  # noqa: E731
        want = wrap(tracers.track_cloud_plain(*args, cfg, mode))
    before = launcher.launches, launcher.options_launches
    got = run(cfg)
    assert (launcher.launches, launcher.options_launches) == (before[0] + 1, before[1] + 1)
    # lanes where the twin on the card parts (its Python divisors round as
    # a multiply by float32(1 / b) there) hold the twin's bits on the CPU
    parted = sum((g.view(torch.int32) != w.view(torch.int32)).reshape(N, -1).any(-1)
                 for g, w in zip(got, want))
    lanes = torch.nonzero(parted).squeeze(1)
    assert lanes.numel() <= 16
    if lanes.numel():
        cpu = [a[lanes].cpu() if a.shape[:1] == (N,) else a.cpu() for a in args]
        host = (tracers.delta_track_rmo_plain(*cpu, cfg) if tracker == "rmo_delta" else
                (tracers.ratio_track_rmo_plain(*cpu, cfg),) if tracker.startswith("rmo") else
                wrap(tracers.track_cloud_plain(*cpu, cfg, mode)))
        assert all(torch.equal(g[lanes].cpu().view(torch.int32), h.view(torch.int32))
                   for g, h in zip(got, host))
    assert not all(torch.equal(g, d) for g, d in zip(got, run(threefry)))


# The march floors (render/params.FLOOR_OPTIONS): the reference's settings
# cert_u0, cert_u001, cert25_u0, floor_sec01 and floor_pri05_sec005
# (tools/stage_bench.py), cert_u0 with the analytic flight, marching first
# and with naive_shadow, and floor_pri05_sec005 with naive_march (whose
# marches have no floor); all run the bounce entries' floor instances
CERT_U0 = dict(march_certified_floor=True, march_uncert_floor_frac=1e-6)
PRI05_SEC005 = dict(march_floor_frac=0.05, march_floor_frac_secondary=0.005)
FLOOR_CASES = [
    CERT_U0, dict(march_certified_floor=True, march_uncert_floor_frac=0.001),
    dict(march_certified_floor=True, march_floor_frac=0.25, march_uncert_floor_frac=1e-6),
    dict(march_floor_frac_secondary=0.01), PRI05_SEC005,
    dict(analytic_flight=True, **CERT_U0), dict(lazy_march=False, **CERT_U0),
    dict(naive_shadow=True, **CERT_U0), dict(naive_march=True, **PRI05_SEC005),
]
MARCH_FLOOR_CASES = FLOOR_CASES[:5]


@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("options", FLOOR_CASES)
def test_bounce_floor_instance_bit_equal_at_march_floors(dev, bounce, options):
    """The bounce entries' floor instances at the march floors, as
    test_bounce_options_instance_bit_equal holds the scene options (the
    census counts the certified marches' iterations)."""
    test_bounce_options_instance_bit_equal(dev, bounce, options)


@pytest.mark.parametrize("options", FLOOR_CASES)
def test_bounce_window_floor_instance_bit_equal_at_march_floors(dev, options):
    """bounce_window from bounce 1 at the march floors: each bounce's floor
    inside the one launch (the secondary floor past bounce 0)."""
    test_bounce_window_options_instance_bit_equal(dev, options)


def test_march_uncert_floor_frac_alone_runs_the_default_instances(dev):
    """march_uncert_floor_frac without the certified floor changes nothing:
    the default instances run and give the default config's bits."""
    from digital_earth_tpu_torch import kernels

    for bounce in (0, 3):
        st, args = _golden_state(dev, bounce)
        idx, n_live = _live(st)
        idx = idx[: int(n_live)]
        u0 = args[:3] + (TraceConfig(**dict(vars(args[3]), march_uncert_floor_frac=1e-6)),)
        before = kernels.bounce_flight.options_launches
        got = _bounce_both(st, idx, bounce, u0, pt.BounceFrame(st, *u0))
        assert kernels.bounce_flight.options_launches == before
        assert _same_state(got, _bounce_both(st, idx, bounce, args, pt.BounceFrame(st, *args)))


@pytest.mark.parametrize("options", MARCH_FLOOR_CASES)
def test_land_march_floor_instance(case, options):
    """land_march at each setting bit-equal to intersect_land_plain, plain,
    any-hit and capped, at the march's own floor and at the primary
    marches' floors of bounces 0 and 1 (the certified floor runs the floor
    instance, counted as an options launch; a secondary floor alone the
    default instance at that floor)."""
    from digital_earth_tpu_torch import kernels

    dev = case["pos"].device
    cfg = TraceConfig(**options)
    topo = case["atlas"].topography
    args = (topo, case["pos"], case["dirs"], torch.tensor(7800.0, device=dev), case["active"],
            cfg)
    t_cap = torch.rand(N, device=dev) * 3e7 + 1e3
    for bounce in (None, 0, 1):
        floor = tracers._march_floor(topo, cfg, bounce)
        for kw in (dict(), dict(any_hit=True), dict(t_cap=t_cap)):
            before = kernels.land_march.launches, kernels.land_march.options_launches
            got = tracers.intersect_land(*args, floor=floor, **kw)
            assert (kernels.land_march.launches, kernels.land_march.options_launches) == (
                before[0] + 1, before[1] + int(cfg.march_certified_floor))
            assert _bits_equal(got, tracers.intersect_land_plain(*args, floor=floor, **kw))


@pytest.mark.parametrize("options", [o for o in MARCH_FLOOR_CASES if "march_certified_floor" in o])
def test_preview_floor_instance(dev, options):
    """preview's floor instance bit-equal to march_paths_plain on every lane
    of a 160x90 frame at each certified floor (counted as an options
    launch)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raymarcher

    args, kw = _preview_lanes(dev, (160, 90), True)
    args = args[:7] + (TraceConfig(bilinear_materials=True, **options),)
    before = kernels.preview.launches, kernels.preview.options_launches
    got = raymarcher.march_paths(*args, **kw)
    assert (kernels.preview.launches, kernels.preview.options_launches) == (
        before[0] + 1, before[1] + 1)
    assert _bits_equal(got, raymarcher.march_paths_plain(*args, **kw))


def test_mesh_on_one_card_at_march_floors_matches_renderer(dev):
    """A (4, 1) mesh over cuda:0 at the certified and secondary floors
    bit-equal to the Renderer over 2 spp, every bounce launch of each shard
    the floor instances'."""
    from digital_earth_tpu_torch import kernels

    trace = TraceConfig(march_floor_frac_secondary=0.01, **CERT_U0)
    m, s = _mesh_renderers([torch.device("cuda:0")] * 4, trace=trace)
    kernels.reset_launch_counts()
    for _ in range(2):
        m.accumulate()
    counts = kernels.launch_counts()
    # the shards' few lanes may all run in the window
    assert counts["bounce_flight"] + counts["bounce_window"] > 0 and all(
        counts[f"{k}/options"] == counts[k] for k in ("bounce_flight", "bounce_shade",
                                                       "bounce_window"))
    for _ in range(2):
        s.accumulate()
    assert torch.equal(m.color_buffer, s.color_buffer)


# --- the hero-packet widths other than 1 and 4 (the width libraries) -------------

WIDTHS = (2, 6, 16)


@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("options", [{}, dict(analytic_transmittance=False),
                                     dict(enable_clouds=False, **CERT_U0)])
@pytest.mark.parametrize("L", WIDTHS)
def test_width_bounce_bit_equal(dev, L, options, bounce):
    """The bounce entries of L's width library bit-equal to run_bounce_plain
    on every live lane: the default instances at the defaults and with the
    gases' sun transmittance by ratio tracking, the floor instances at an
    option with the certified floor; each launch counted at its width, as
    an options launch in the floor instances only."""
    from digital_earth_tpu_torch import kernels

    st, args = _golden_state(dev, bounce, options=dict(hero_lambdas=L, **options))
    assert st.wavelength.shape[1] == L
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    assert idx.numel() > 0
    before = kernels.launch_counts().get(f"bounce_flight/L{L}", 0)
    floors = kernels.bounce_flight.options_launches
    got = _bounce_both(st, idx, bounce, args, pt.BounceFrame(st, *args))
    assert kernels.launch_counts()[f"bounce_flight/L{L}"] == before + 1
    assert kernels.bounce_flight.options_launches - floors == int("enable_clouds" in options)
    assert _same_state(got.take(idx.long()), pt.run_bounce_plain(st.take(idx.long()), bounce,
                                                                 *args))


@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("ratio", [False, True])
@pytest.mark.parametrize("L", WIDTHS)
def test_width_bounce_floor_instances_bit_equal(dev, L, ratio, bounce):
    """The floor instances of L's width library, forced at the defaults (and
    with the ratio-tracked sun transmittance), bit-equal to run_bounce_plain
    and to the default instances on every live lane."""
    from digital_earth_tpu_torch import kernels

    options = dict(hero_lambdas=L, analytic_transmittance=not ratio)
    st, args = _golden_state(dev, bounce, options=options)
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    frame = pt.BounceFrame(st, *args)
    floors = kernels.bounce_flight.options_launches
    forced = _bounce_both(st, idx, bounce, args, frame, options=True)
    assert kernels.bounce_flight.options_launches == floors + 1
    lanes = idx.long()
    assert _same_state(forced.take(lanes), pt.run_bounce_plain(st.take(lanes), bounce, *args))
    assert _same_state(forced, _bounce_both(st, idx, bounce, args, frame))


@pytest.mark.parametrize("L", WIDTHS)
def test_width_bounce_window_bit_equal(dev, L):
    """bounce_window of L's width library from bounce 1 to the last against
    run_window_plain, every lane bit-equal."""
    st, args = _golden_state(dev, 1, options=dict(hero_lambdas=L))
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    got, want = _clone_state(st), _clone_state(st)
    before = kernels_launches("bounce_window")
    pt.run_window(got, idx, 1, args[3].max_bounces, *args)
    assert kernels_launches("bounce_window") == before + 1
    pt.run_window_plain(want, idx, 1, args[3].max_bounces, *args)
    assert _same_state(got, want)


@pytest.mark.parametrize("ratio, floors", [(False, True), (True, False), (True, True)])
@pytest.mark.parametrize("L", WIDTHS)
def test_width_bounce_window_instances_bit_equal(dev, monkeypatch, L, ratio, floors):
    """bounce_window of L's width library from bounce 1 against
    run_window_plain in the floor instances (forced) and with the
    ratio-tracked sun transmittance, every lane bit-equal."""
    from digital_earth_tpu_torch import kernels

    st, args = _golden_state(dev, 1, options=dict(hero_lambdas=L,
                                                  analytic_transmittance=not ratio))
    idx, n_live = _live(st)
    idx = idx[: int(n_live)]
    got, want = _clone_state(st), _clone_state(st)
    if floors:
        monkeypatch.setattr(kernels, "_knob_instance", lambda fp, ip: kernels.INST_FLOORS)
    before = kernels.bounce_window.options_launches
    pt.run_window(got, idx, 1, args[3].max_bounces, *args)
    assert kernels.bounce_window.options_launches == before + int(floors)
    pt.run_window_plain(want, idx, 1, args[3].max_bounces, *args)
    assert _same_state(got, want)


@pytest.mark.parametrize("L", WIDTHS)
def test_width_occupancy_of_both_instances(dev, L):
    """A width library answers the occupancy of its default and its floor
    instances (registers, resident warps) for each bounce entry."""
    from digital_earth_tpu_torch import kernels

    for which in kernels.OCCUPANCY_ENTRIES:
        for inst in (kernels.INST_DEFAULT, kernels.INST_FLOORS):
            o = kernels.bounce_occupancy(which, inst, width=L)
            assert 0 < o["registers"] <= 255 and o["warps_per_sm"] > 0


@pytest.mark.parametrize("L", WIDTHS)
def test_width_gen_rays_bit_equal(dev, L):
    """gen_rays of L's width library (its rotations l * float32(1 / L), as
    the twin's) bit-equal to its twin on a 320x180 path frame."""
    from digital_earth_tpu_torch.render import raygen

    res = (320, 180)
    r = _apollo_renderer(dev, res, "path")
    args = ((0, 3), 5, 0, res[0] * res[1], res, (1, res[1]), r.camera_params(), r.luts, False,
            None, TraceConfig(hero_lambdas=L))
    before = kernels_launches("gen_rays")
    got = raygen.gen_rays(*args)
    assert kernels_launches("gen_rays") == before + 1 and got.wavelengths.shape[1] == L
    _rays_equal(got, raygen.gen_rays_plain(*args))


@pytest.mark.parametrize("case", ["tail", "tiles", "preview"])
@pytest.mark.parametrize("L", [1, 2, 3, 6, 7, 16])
def test_gen_rays_packet_stores_bit_equal(dev, L, case):
    """gen_rays' packet stores (every L but 4) bit-equal to its twin on a
    320x180 Apollo frame: lanes [77, 10080), whose last block of 19 lanes
    ends its runs in a scalar tail where 19 L is not a multiple of 4; a
    seeded quarter of the frame's tiles (an adaptive pass's tile list); the
    preview at L = 1 (its one wavelength and the pdf's reciprocal)."""
    from digital_earth_tpu_torch.render import raygen

    if case == "preview" and L != 1:
        pytest.skip("the preview samples one wavelength")
    res = (320, 180)
    r = _apollo_renderer(dev, res, "preview" if case == "preview" else "path")
    cfg = TraceConfig(hero_lambdas=L)
    if case == "tail":
        args = ((0, 3), 5, 77, 10003, res, (1, res[1]), r.camera_params(), r.luts, False, None,
                cfg)
    elif case == "tiles":
        bw, bh = r.block
        n_tiles = (res[0] // bw) * (res[1] // bh)
        order = torch.randperm(n_tiles, generator=torch.Generator().manual_seed(L))
        tiles = order[: n_tiles // 4].to(torch.int32).to(dev)
        args = ((0, 3), 5, 0, tiles.numel() * bw * bh, res, (bw, bh), r.camera_params(), r.luts,
                False, tiles, cfg)
    else:
        args = ((0, 3), 5, 0, res[0] * res[1], res, r.block, r.camera_params(), r.luts, True,
                None, cfg)
    got = raygen.gen_rays(*args)
    assert got.wavelengths.shape[1] == (1 if case == "preview" else L)
    _rays_equal(got, raygen.gen_rays_plain(*args))


@pytest.mark.parametrize("L", [2, 4])
def test_gen_rays_widest_table(dev, L):
    """gen_rays on a 3072-entry CIE table, the widest its wrapper takes: the
    table's 48 KiB and the directions' 3 KiB of shared memory pass a block's
    48 KiB without opting in, so the launch opts in; bit-equal to its twin."""
    from digital_earth_tpu_torch.render import raygen

    res = (320, 180)
    r = _apollo_renderer(dev, res, "path")
    x, xp = np.linspace(0.0, 1.0, 3072), np.linspace(0.0, 1.0, r.luts.cie_cdf.shape[0])
    wide = r.luts._replace(**{
        name: torch.tensor(np.stack([np.interp(x, xp, col) for col in
                                     getattr(r.luts, name).cpu().numpy().T], axis=1),
                           dtype=torch.float32, device=dev)
        for name in ("cie_cdf", "cie_response")})
    args = ((0, 3), 5, 0, 8192, res, (1, res[1]), r.camera_params(), wide, False, None,
            TraceConfig(hero_lambdas=L))
    _rays_equal(raygen.gen_rays(*args), raygen.gen_rays_plain(*args))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("L", WIDTHS)
def test_width_rmo_ratio_track_bit_equal(case, L, k):
    """rmo_ratio_track of L's width library bit-equal to its twin on every
    lane, each lane's iterations the twin's."""
    dev = case["pos"].device
    wl = torch.rand((N, L), generator=torch.Generator().manual_seed(L)).to(dev) * 441 + 390
    ext = torch.stack([
        vol.spectra_extinction_rayleigh(wl), vol.spectra_extinction_mie(wl),
        vol.spectra_extinction_ozone(wl, load_spectral_luts(dev).o3_crossec),
    ], dim=-1).contiguous()
    t0, t1 = pt._rmo_span(case["pos"], case["dirs"], torch.full((N,), -1.0, device=dev))
    got, iters, want, trips = _ratio_both((case["keys"], case["pos"], case["dirs"], t0, t1, ext,
                                           vol.max_extinction_rmo(ext), case["active"]), k)
    assert got.shape == (N, L) and _bits_equal(got, want) and torch.equal(iters, trips)


@pytest.mark.parametrize("L", [6, 16])
def test_width_frame_end_kernel(dev, L):
    """frame_end at L (16: L's width library, past the main library's 8) on
    50,000 lanes with counts, against its twin."""
    from digital_earth_tpu_torch.render import frame_end as fe
    from digital_earth_tpu_torch.render.params import make_scene_params

    g = torch.Generator().manual_seed(L)
    n, n_pix = 50000, 80000
    scene = make_scene_params(dev, 1.0, -0.5)
    rad = torch.exp(torch.randn((n, L), generator=g) * 2 - 2)
    rad[torch.rand((n, L), generator=g) < 0.02] = float("nan")
    fields = dict(
        pos=torch.zeros((n, 3)),
        direction=torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1),
        wavelength=torch.rand((n, L), generator=g) * 441 + 390,
        lambda_pdf=torch.rand((n, L), generator=g) * 0.01,
        throughput=torch.rand((n, L), generator=g) * 1.5, radiance=rad,
        w_mis=torch.rand((n, L), generator=g) + 0.5, alive=torch.zeros(n, dtype=torch.bool),
        primary_miss=torch.rand(n, generator=g) < 0.4, rng=torch.zeros((n, 2), dtype=torch.int64),
        work_class=torch.zeros(n, dtype=torch.int32))
    st = pt.TraceState(**{k: v.to(dev) for k, v in fields.items()})
    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), dev)
    miss = fe.MissShading(st, scene, atlas, load_spectral_luts(dev), TraceConfig(hero_lambdas=L))
    responses = (torch.rand((n, L, 3), generator=g) * 2).to(dev)
    pid = torch.randperm(n_pix, generator=g)[:n].to(dev)
    outs = []
    for fn in (fe.frame_end, fe.frame_end_plain):
        color, cnt, l2 = (torch.zeros(s, device=dev) for s in ((n_pix, 3), n_pix, n_pix))
        before = kernels_launches("frame_end")
        fn(responses, pid, color, cnt, l2, miss=miss)
        outs.append((color, cnt, l2, kernels_launches("frame_end") - before))
    (kc, kn, kl, k_launch), (pc, pn, pl, p_launch) = outs
    assert (k_launch, p_launch) == (1, 0) and kernels_launches(f"frame_end/L{L}") >= 1
    assert _rel_close(kc, pc) and torch.equal(kn, pn) and _rel_close(kl, pl)


def _trace_mean_xyz(dev, atlas, luts, L, n, seed):
    """tests/test_hero_packets.py's estimator on the card: n paths from the
    Apollo camera towards seeded points about the planet (3 bounces), the
    hero by CIE inverse CDF with L - 1 rotations, through
    ``pathtracer.trace_paths``; each path's XYZ."""
    from digital_earth_tpu_torch.ops import spectral as sp
    from digital_earth_tpu_torch.render.params import make_scene_params

    cfg = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256,
                      hero_lambdas=L)
    g = np.random.default_rng(seed)
    cam = torch.tensor([35963490.0, 12765367.0, -42445899.0], device=dev)
    target = torch.from_numpy(g.normal(size=(n, 3)) * 4e6).to(dev, torch.float32)
    dirs = torch.nn.functional.normalize(target - cam, dim=-1).contiguous()
    u = torch.from_numpy(g.uniform(size=n).astype(np.float32)).to(dev)
    wl, resp, pdf = sp.spectrum_sample_hero(u, luts.cie_cdf, luts.cie_response, L)
    rad = pt.trace_paths(rng.prng_key(seed, dev), cam.expand(n, 3).contiguous(), dirs, wl,
                         make_scene_params(dev), atlas, luts, cfg, lambda_pdf=pdf)
    return torch.einsum("nl,nlc->nc", rad, resp).double().cpu().numpy()


@pytest.fixture(scope="module")
def packet_scene(dev):
    return build_atlas(generate_earth_textures((64, 128), seed=3), dev), load_spectral_luts(dev)


@pytest.mark.parametrize("L", [4, 2, 6, 16])
def test_packet_estimator_unbiased_vs_single(dev, packet_scene, L):
    """tests/test_hero_packets.py's multi-seed z-test on the card: the L
    estimator's mean XYZ agrees with the L = 1 estimator's within
    Monte-Carlo error (|z| < 4 over 6 seeds of 3072 paths each)."""
    n, n_seeds = 3072, 6
    a = np.stack([_trace_mean_xyz(dev, *packet_scene, 1, n, 10 + s).mean(0)
                  for s in range(n_seeds)])
    b = np.stack([_trace_mean_xyz(dev, *packet_scene, L, n, 50 + s).mean(0)
                  for s in range(n_seeds)])
    sem = np.sqrt(a.var(axis=0) / n_seeds + b.var(axis=0) / n_seeds)
    z = (b.mean(0) - a.mean(0)) / (sem + 1e-5 * np.abs(a.mean(0)) + 1e-9)
    assert (np.abs(z) < 4.0).all(), (a.mean(0), b.mean(0), z)


def test_packet_reduces_variance(dev, packet_scene):
    """tests/test_hero_packets.py's chroma test on the card: the median over
    4 seeds of the X - Y residual variance at L = 4 under 0.3 of L = 1's."""
    def chroma_var(L, s):
        xyz = _trace_mean_xyz(dev, *packet_scene, L, 2048, 100 * L + s)
        return (xyz[:, 0] - xyz[:, 1]).var()

    c1 = float(np.median([chroma_var(1, s) for s in range(4)]))
    c4 = float(np.median([chroma_var(4, s) for s in range(4)]))
    assert c4 < c1 * 0.3, (c1, c4)


# --- the naive arm in every knob instance set ------------------------------------
# each naive flag with an estimator option (the estimator instances) and with
# the certified floor (the floor instances), and two flags in the width
# libraries' floor instances, on three scenes

NAIVE_FLAGS = [dict(naive_tracking=True, hero_lambdas=1), dict(naive_march=True),
               dict(naive_cloud_tracking=True), dict(naive_shadow=True)]
NAIVE_KNOB_CASES = [dict(**flag, **option) for flag in NAIVE_FLAGS for option in (
    dict(fast_loop_rng=True), dict(nee_off=True), dict(nee_rr_prob=0.5, nee_rr_start=-1),
    CERT_U0)]


@pytest.mark.parametrize("scene", NAIVE_SCENES)
@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("options", NAIVE_KNOB_CASES)
def test_bounce_knob_instances_bit_equal_at_naive_flags(dev, options, bounce, scene):
    """The estimator and floor instances at each naive flag, their naive
    trackers warp-cooperative and their march block-cooperative, bit-equal
    to run_bounce_plain with the census's trips."""
    _hold_bounce_instance(dev, bounce, options, scene)


@pytest.mark.parametrize("scene", NAIVE_SCENES)
@pytest.mark.parametrize("options", NAIVE_KNOB_CASES)
def test_bounce_window_knob_instances_bit_equal_at_naive_flags(dev, options, scene):
    _hold_window_instance(dev, options, scene)


@pytest.mark.parametrize("scene", NAIVE_SCENES)
@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("flag", ["naive_cloud_tracking", "naive_march"])
@pytest.mark.parametrize("L", (2, 6))
def test_width_bounce_bit_equal_at_naive_flags(dev, L, flag, bounce, scene):
    """The width libraries' floor instances at a naive flag."""
    _hold_bounce_instance(dev, bounce, {"hero_lambdas": L, flag: True}, scene)


@pytest.mark.parametrize("scene", NAIVE_SCENES)
@pytest.mark.parametrize("flag", ["naive_cloud_tracking", "naive_march"])
@pytest.mark.parametrize("L", (2, 6))
def test_width_bounce_window_bit_equal_at_naive_flags(dev, L, flag, scene):
    _hold_window_instance(dev, {"hero_lambdas": L, flag: True}, scene)
