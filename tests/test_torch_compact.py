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


# --- the card's schedule: one launch per bounce, then the window -----------


@pytest.mark.parametrize("n,counts,window_at,want", [
    # wide bounces until the count the host holds drops below the threshold
    (100, [90, 50, 10, 5, 0], 20, ([0, 1, 2], 3)),
    # a wavefront below the threshold is one window from its first bounce
    (10, [9, 4], 20, ([], 0)),
    # a count of 0 ends the loop before the window
    (100, [90, 50, 30, 0, 0], 20, ([0, 1, 2, 3], None)),
    # threshold 0: every bounce one launch, to the last
    (100, [90, 50, 10, 5, 1], 0, ([0, 1, 2, 3, 4], None)),
])
def test_bounce_schedule(n, counts, window_at, want):
    assert pt.bounce_schedule(n, counts, window_at, 0, len(counts)) == want
    # from a later bounce the same rule holds, bounce numbers shifted
    single, window = pt.bounce_schedule(n, counts, window_at, 3, 3 + len(counts))
    assert single == [b + 3 for b in want[0]]
    assert window == (None if want[1] is None else want[1] + 3)


def _window_case(scene, k):
    """The 32x18 wavefront of ``scene`` with 5 bounces, advanced to bounce
    ``k`` on the CPU, and its live list there."""
    st, r, _ = _bounce0_state(scene)
    cfg = TraceConfig(max_bounces=5, land_march_steps=64, max_tracking_steps=256)
    args = (r.scene_params(), r.atlas, r.luts, cfg)
    st = pt.run_bounces(st, *args, 0, k)
    idx, n_live = compact.compact_by_alive(st.alive, st.work_class)
    return st, idx[: int(n_live)], args, cfg


@pytest.mark.parametrize("scene", ["config - Apollo 11.txt", "config - florida.txt"])
def test_window_twin_matches_the_per_bounce_schedule(scene):
    """run_window_plain (bounce_window's twin) over bounces 1-4 of the live
    lanes leaves the state of four more one-bounce steps, bit for bit: each
    bounce it lists the set's live lanes as run_bounces lists them."""
    st, idx, args, cfg = _window_case(scene, 1)
    per_bounce = pt.run_bounces(_clone(st), *args, 1, cfg.max_bounces)
    window = pt.run_window_plain(_clone(st), idx, 1, cfg.max_bounces, *args)
    for name in ("pos", "direction", "throughput", "radiance", "w_mis", "alive",
                 "primary_miss", "work_class"):
        assert torch.equal(getattr(window, name), getattr(per_bounce, name)), name
    assert per_bounce.radiance.sum() > 0 and idx.numel() > 0


@pytest.mark.parametrize("scene", ["config - Apollo 11.txt", "config - florida.txt"])
def test_twin_trip_counts_do_not_depend_on_the_schedule(scene):
    """The twin's census (trips per lane at the seven loop sites) is the same
    bounce by bounce and through run_window_plain, and within the loops'
    caps."""
    st, idx, args, cfg = _window_case(scene, 1)
    n, nb = st.alive.numel(), cfg.max_bounces - 1
    per_bounce = torch.zeros((nb, n, 7), dtype=torch.int32)
    st1 = _clone(st)
    for b in range(1, cfg.max_bounces):
        lanes, n_live = compact.compact_by_alive(st1.alive, st1.work_class)
        lanes = lanes[: int(n_live)].long()
        if lanes.numel() == 0:
            break
        t = torch.zeros((lanes.numel(), 7), dtype=torch.int32)
        st1.put(lanes, pt.run_bounce_plain(st1.take(lanes), b, *args, trips=t))
        per_bounce[b - 1, lanes] = t
    window = torch.zeros_like(per_bounce)
    pt.run_window_plain(_clone(st), idx, 1, cfg.max_bounces, *args, trips=window)
    assert torch.equal(per_bounce, window)
    march_cap = -(-cfg.land_march_steps // cfg.march_k)
    caps = torch.tensor([march_cap, cfg.max_tracking_steps, cfg.max_tracking_steps, march_cap,
                         march_cap, cfg.max_tracking_steps, 0], dtype=torch.int32)
    assert (window <= caps).all() and (window >= 0).all()
    # the flight's passes run on every live lane; the rest where they apply
    assert window[..., 1:3].sum() > 0 and window.sum() > window[..., 1:3].sum()


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_bounce_census_arithmetic():
    """chip_smoke.py's operations from trip counts (all of them, and their
    integer share) and SIMT efficiency, on a hand-counted case: the second
    lane took the sun's transmittance by ratio tracking (NEE RMO trips), so
    it counts no closed-form term; a census of six sites (a package without
    the NEE RMO column) counts as the seven's first six."""
    cs = _chip_smoke()
    trips = torch.tensor([[0, 1, 2, 0, 0, 1, 0], [0, 3, 2, 1, 1, 1, 2]], dtype=torch.int32)
    k = 4

    def site(j, n, tracking_k, tables):
        # a call and n iterations; a march or RMO iteration's K probes but
        # the last iteration's one, a cloud iteration's one
        call, it, probe = tables
        if n == 0:
            return 0
        kj = 1 if j in (1, 5) else (tracking_k if j in (2, 6) else k)
        return call[j] + n * it[j] + (kj * n - (kj - 1)) * probe[j]

    ops_tables = (cs.BOUNCE_CALL_OPS, cs.BOUNCE_ITER_OPS, cs.BOUNCE_PROBE_OPS)
    int_tables = (cs.BOUNCE_CALL_INT, cs.BOUNCE_ITER_INT, cs.BOUNCE_PROBE_INT)
    for tracking_k in (4, 6):
        sites = lambda tables, cols=7: sum(  # noqa: E731
            site(j, int(trips[i, j]), tracking_k, tables) for i in range(2) for j in range(cols))
        want = (2 * cs.BOUNCE_FIXED_OPS + cs.BOUNCE_SURFACE_OPS + 2 * cs.BOUNCE_NEE_OPS
                + cs.BOUNCE_CLOSED_FORM_OPS + sites(ops_tables))
        assert cs.bounce_ops(torch, trips, k, tracking_k) == want
        want_int = (2 * cs.BOUNCE_FIXED_INT + cs.BOUNCE_SURFACE_INT + 2 * cs.BOUNCE_NEE_INT
                    + sites(int_tables))
        assert cs.bounce_ops(torch, trips, k, tracking_k, integer=True) == want_int
        six = (2 * cs.BOUNCE_FIXED_OPS + cs.BOUNCE_SURFACE_OPS
               + 2 * (cs.BOUNCE_NEE_OPS + cs.BOUNCE_CLOSED_FORM_OPS) + sites(ops_tables, 6))
        assert cs.bounce_ops(torch, trips[:, :6], k, tracking_k) == six
        for j in (1, 2, 6):
            for tables, integer in ((ops_tables, False), (int_tables, True)):
                assert cs.tracker_ops(torch, trips[:, j], tracking_k, j, integer=integer) == (
                    site(j, int(trips[0, j]), tracking_k, tables)
                    + site(j, int(trips[1, j]), tracking_k, tables))
    # warps of 2: per site the lanes' trips over 2 x the warp's largest
    assert cs.simt_efficiency(torch, trips, warp=2) == [None, 4 / 6, 1.0, 0.5, 0.5, 1.0, 0.5]
    assert cs.tracker_simt(torch, trips, warp=2) == [4 / 6, 1.0, 1.0, 0.5]
    assert cs.tracker_simt(torch, trips[:, :6], warp=2) == [4 / 6, 1.0, 1.0]
    # a ragged last warp counts its idle lanes
    assert cs.simt_efficiency(torch, trips[:1], warp=4)[2] == 2 / 8
    # the clock64 columns: the sites, then the flight's and the shade's whole
    cycles = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 40, 60]], dtype=torch.int64)
    sites, flight, shade, total = cs.cycle_split(torch, cycles)
    assert total == 100.0 and (flight, shade) == (0.4, 0.6) and sites == [
        x / 100 for x in range(1, 8)]

# ptxas's report of bounce.cu as nvcc 12.9 prints it (sm_90a, BOUNCE_L 4):
# the timed instances, a census instance and a device function between them
_PTXAS_BOUNCE = """\
ptxas info    : Function properties for _ZN2de20bounce_window_kernelILi4EEEvNS_11BounceStateENS_12BounceParamsEi
    80 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN2de10cloud_callENS_3KeyENS_2V3ES1_fffPKhiiiib
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN2de19bounce_shade_kernelILi4ELb1EEEvNS_11BounceStateENS_12BounceParamsEPK6float4
    112 bytes stack frame, 40 bytes spill stores, 40 bytes spill loads
ptxas info    : Function properties for _ZN2de19bounce_shade_kernelILi4ELb0EEEvNS_11BounceStateENS_12BounceParamsEPK6float4
    80 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN2de20bounce_flight_kernelILi8ELb0EEEvNS_11BounceStateENS_12BounceParamsEP6float4
    56 bytes stack frame, 24 bytes spill stores, 28 bytes spill loads
"""


@pytest.mark.parametrize("drop", [None, "bounce_flight"])
def test_bounce_registers_reads_the_timed_instances(drop):
    """chip_smoke.py's spill bytes per bounce entry come from the timed
    instances (any lane width, not the census's), and a report that lacks
    an entry fails."""
    import types

    cs = _chip_smoke()
    log = "\n".join(l for l in _PTXAS_BOUNCE.splitlines(keepends=False)
                    if not (drop and "flight" in l and "Function" in l))
    occ = dict(registers=64, local_bytes=56, warps_per_sm=32)
    kern = types.SimpleNamespace(ptxas_log={"bounce.cu": log},
                                 OCCUPANCY_ENTRIES=("bounce_flight", "bounce_shade",
                                                    "bounce_window"),
                                 bounce_occupancy=lambda name: occ)
    if drop:
        with pytest.raises(SystemExit):
            cs.bounce_registers(kern)
        return
    got = cs.bounce_registers(kern)
    assert {n: (r["spill_stores"], r["spill_loads"]) for n, r in got.items()} == {
        "bounce_flight": (24, 28), "bounce_shade": (0, 0), "bounce_window": (0, 0)}
    assert got["bounce_flight"]["registers"] == 64
    # no report (a build from an earlier process): no spills, no failure
    kern.ptxas_log = {}
    assert all(r["spill_stores"] is None for r in cs.bounce_registers(kern).values())