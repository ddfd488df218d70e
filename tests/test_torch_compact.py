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

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

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
    """chip_smoke.py's operations from trip counts, as (other operations,
    threefry's ALU-pipe instructions, its FMA-pipe ones) at a SASS census of
    a block and a draw, and SIMT efficiency, on a hand-counted case, at the
    source's count of threefry (77 ALU-pipe operations a block, 80 a draw)
    and at a SASS-like split: the second lane took the sun's transmittance
    by ratio tracking (NEE RMO trips), so it counts no closed-form term; a
    census of six sites (a package without the NEE RMO column) counts as the
    seven's first six; the flight and the shade add up to the bounce; the
    tables without threefry plus its source count are the first counts; no
    census, no count."""
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

    tf_tables = (cs.BOUNCE_CALL_TF, cs.BOUNCE_ITER_TF, cs.BOUNCE_PROBE_TF)
    ops_tables = (cs.BOUNCE_CALL_OPS, cs.BOUNCE_ITER_OPS, cs.BOUNCE_PROBE_OPS)
    blk_tables = tuple(tuple(x[0] for x in t) for t in tf_tables)
    drw_tables = tuple(tuple(x[1] for x in t) for t in tf_tables)
    fixed = (cs.BOUNCE_FIXED_TF, cs.BOUNCE_SURFACE_TF, cs.BOUNCE_NEE_TF)
    source = {"block": {"alu": 77.0, "imad": 0.0}, "draw": {"alu": 80.0, "imad": 0.0}}
    sass_like = {"block": {"alu": 50.0, "imad": 17.0}, "draw": {"alu": 46.0, "imad": 17.0}}
    for tf in (source, sass_like):

        def split(blocks, draws):
            # threefry's (ALU-pipe, FMA-pipe) instructions
            return (blocks * tf["block"]["alu"] + draws * tf["draw"]["alu"],
                    blocks * tf["block"]["imad"] + draws * tf["draw"]["imad"])

        for tracking_k in (4, 6):
            sites = lambda tables, cols=7: sum(  # noqa: E731
                site(j, int(trips[i, j]), tracking_k, tables) for i in range(2)
                for j in range(cols))
            for cols, closed in ((7, 1), (6, 2)):
                blocks = (2 * fixed[0][0] + fixed[1][0] + 2 * fixed[2][0]
                          + sites(blk_tables, cols))
                draws = (2 * fixed[0][1] + fixed[1][1] + 2 * fixed[2][1]
                         + sites(drw_tables, cols))
                other = (2 * cs.BOUNCE_FIXED_OPS + cs.BOUNCE_SURFACE_OPS + 2 * cs.BOUNCE_NEE_OPS
                         + closed * cs.BOUNCE_CLOSED_FORM_OPS + sites(ops_tables, cols))
                t = trips[:, :cols]
                got = cs.bounce_ops(torch, t, k, tracking_k, tf)
                assert got == (other, *split(blocks, draws))
                halves = [cs.bounce_ops(torch, t, k, tracking_k, tf, part)
                          for part in ("flight", "shade")]
                assert tuple(a + b for a, b in zip(*halves)) == got
            for j in (1, 2, 6):
                per = [sum(site(j, int(trips[i, j]), tracking_k, tab) for i in range(2))
                       for tab in (ops_tables, blk_tables, drw_tables)]
                assert cs.tracker_ops(torch, trips[:, j], tracking_k, j, tf) == (
                    per[0], *split(per[1], per[2]))
    # the tables without threefry, plus 77 a block and 80 a draw, are the
    # counts as first made from the source
    src = lambda x: 77 * x[0] + 80 * x[1]  # noqa: E731
    for ops, tfs, first in ((cs.BOUNCE_CALL_OPS, cs.BOUNCE_CALL_TF, (59, 2, 19, 59, 59, 2, 106)),
                            (cs.BOUNCE_ITER_OPS, cs.BOUNCE_ITER_TF, (4, 5, 120, 4, 4, 5, 80)),
                            (cs.BOUNCE_PROBE_OPS, cs.BOUNCE_PROBE_TF,
                             (110, 45, 230, 110, 110, 45, 155))):
        assert tuple(o + src(x) for o, x in zip(ops, tfs)) == first
    assert cs.BOUNCE_FLIGHT_OPS + src(cs.BOUNCE_FLIGHT_TF) == 487
    assert cs.BOUNCE_FIXED_OPS + src(cs.BOUNCE_FIXED_TF) == 487 + 774
    assert cs.BOUNCE_SURFACE_OPS + src(cs.BOUNCE_SURFACE_TF) == 1081
    assert cs.BOUNCE_NEE_OPS + src(cs.BOUNCE_NEE_TF) == 225
    assert cs.GEN_RAYS_OPS + 77 * sum(cs.GEN_RAYS_TF) == 680  # a draw counted as a block there
    with pytest.raises(SystemExit):
        cs.tf_ops(1, 1, None)
    # the FMA pipe's integer work has its own rate beside the ALU pipe's
    cs.sm_clock_mhz = lambda: 1980.0
    int_hz = cs.H100_SMS * cs.INT32_PER_SM * 1980.0e6
    assert cs.bound(0, 3e9, int_ops=2e9, fma_ops=1e9)[0] == 2e9 / int_hz * 1e3
    assert cs.bound(0, 3e9, int_ops=1e9, fma_ops=2e9)[0] == 2e9 / int_hz * 1e3
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


def test_cycle_split_reads_the_surface_branch():
    """chip_smoke.py's split of a census with the shade's surface branch
    (the tenth clock64 column, after the two kernels' whole): its share
    follows the seven sites', and the shade's straight-line rest leaves it
    out; a census of six sites (eight columns) and one without the branch
    (nine) read as before."""
    cs = _chip_smoke()
    cycles = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 40, 60, 20],
                           [0, 0, 0, 0, 0, 0, 0, 0, 0, 0]], dtype=torch.int64)
    sites, flight, shade, total = cs.cycle_split(torch, cycles)
    assert total == 100.0 and (flight, shade) == (0.4, 0.6)
    assert sites == [x / 100 for x in range(1, 8)] + [0.2]
    text = cs.split_text((sites, flight, shade, total))
    assert "surface branch 0.200" in text and "rest 0.220)" in text
    assert cs.cycle_split(torch, cycles[:, :9])[0] == sites[:7]
    six = torch.tensor([[1, 2, 3, 4, 5, 6, 40, 60]], dtype=torch.int64)
    assert cs.cycle_split(torch, six)[0] == [x / 100 for x in range(1, 7)]

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

# cuobjdump -sass as CUDA 12 prints it: two fold launchers that differ by one
# block (here five instructions), predicates, NOPs and encodings
_SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN2de20threefry_fold_kernelILi2EEEvPKiijPi
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/              @!P0 EXIT ;                                 /* 0x000000000000094d */
        /*0020*/                   IADD3 R3, R2, R5, RZ ;
        /*0030*/                   SHF.L.W.U32.HI R4, R3, 0xd, R3 ;
        /*0040*/                   LOP3.LUT R4, R4, R3, RZ, 0x3c, !PT ;
        /*0050*/                   IMAD R6, R4, c[0x3][0x0], R3 ;
        /*0060*/                   SHF.L.W.U32.HI R4, R6, 0xf, R6 ;
        /*0070*/                   IADD3 R3, R2, R5, RZ ;
        /*0080*/                   SHF.L.W.U32.HI R4, R3, 0xd, R3 ;
        /*0090*/                   LOP3.LUT R4, R4, R3, RZ, 0x3c, !PT ;
        /*00a0*/                   IMAD.IADD R6, R4, 0x1, R3 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   BRA 0xc0;
        /*00d0*/                   NOP;
\t\t..........
\t\tFunction : _ZN2de20threefry_fold_kernelILi1EEEvPKiijPi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 EXIT ;
        /*0020*/                   IADD3 R3, R2, R5, RZ ;
        /*0030*/                   SHF.L.W.U32.HI R4, R3, 0xd, R3 ;
        /*0040*/                   LOP3.LUT R4, R4, R3, RZ, 0x3c, !PT ;
        /*0050*/                   IMAD R6, R4, c[0x3][0x0], R3 ;
        /*0060*/                   SHF.L.W.U32.HI R4, R6, 0xf, R6 ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
		..........
		Function : _ZN2de24threefry_draw_sum_kernelILi1EEEvPKiijPf
        /*0000*/                   IADD3 R3, R2, R5, RZ ;
        /*0010*/                   FADD R4, R3, -1 ;
        /*0020*/                   EXIT ;
		Function : _ZN2de24threefry_draw_sum_kernelILi2EEEvPKiijPf
        /*0000*/                   IADD3 R3, R2, R5, RZ ;
        /*0010*/                   FADD R4, R3, -1 ;
        /*0020*/                   LOP3.LUT R4, R4, R3, RZ, 0x3c, !PT ;
        /*0030*/                   IMAD.IADD R6, R4, 0x1, R3 ;
        /*0040*/                   FADD R4, R3, -1 ;
        /*0050*/                   FADD R4, R4, R6 ;
        /*0060*/                   EXIT ;
"""


def test_sass_census_counts_one_block():
    """chip_smoke.py reads the SASS of one threefry block as the depth-2
    fold launcher's instructions less the depth-1's, and of one draw as the
    two-word sum launcher's less the one-word's, by opcode and by pipe
    (IMAD on the FMA pipe, IADD3, LOP3 and SHF on the ALU pipe, FADD at the
    FP32 rate, apart), returns their integer instructions for the bounds,
    and fails where the disassembly lacks either pair."""
    import types

    cs = _chip_smoke()
    funcs = cs.parse_sass(_SASS)
    assert sorted(funcs) == ["_ZN2de20threefry_fold_kernelILi1EEEvPKiijPi",
                             "_ZN2de20threefry_fold_kernelILi2EEEvPKiijPi",
                             "_ZN2de24threefry_draw_sum_kernelILi1EEEvPKiijPf",
                             "_ZN2de24threefry_draw_sum_kernelILi2EEEvPKiijPf"]
    assert funcs["_ZN2de20threefry_fold_kernelILi1EEEvPKiijPi"] == [
        "LDC", "EXIT", "IADD3", "SHF.L.W.U32.HI", "LOP3.LUT", "IMAD", "SHF.L.W.U32.HI", "EXIT",
        "BRA"]
    hist, pipes = cs.sass_histogram(["IMAD.IADD", "IADD3", "SHF.L.W.U32.HI", "LDC", "FADD",
                                     "MUFU.RCP"])
    assert hist["IMAD.IADD"] == 1
    assert pipes == {"alu": 2, "imad": 1, "f32": 1, "xu": 1, "other": 1}
    kern = types.SimpleNamespace(library=lambda: types.SimpleNamespace(_name="lib.so"))
    got = cs.sass_census(kern, funcs=funcs)
    assert got["block"]["ops"] == {"IADD3": 1, "SHF.L.W.U32.HI": 1, "LOP3.LUT": 1, "IMAD.IADD": 1}
    assert got["block"]["pipes"] == {"alu": 3, "imad": 1, "f32": 0, "xu": 0, "other": 0}
    assert got["block"]["total"] == 4
    assert got["draw"]["ops"] == {"LOP3.LUT": 1, "IMAD.IADD": 1, "FADD": 2}
    assert got["tf"] == {"block": {"alu": 3.0, "imad": 1.0}, "draw": {"alu": 1.0, "imad": 1.0}}
    assert cs.tf_ops(2, 1, got["tf"]) == (2 * 3 + 1 * 1, 2 * 1 + 1 * 1)
    for drop in ("fold", "draw_sum"):
        with pytest.raises(SystemExit):
            cs.sass_census(kern, funcs={n: f for n, f in funcs.items() if drop not in n})


def test_ptxas_entries_reads_every_kernel():
    """chip_smoke.py's ptxas reader: each entry's registers and spill bytes
    by a readable name, device functions left out."""
    cs = _chip_smoke()
    log = """\
ptxas info    : Compiling entry function '_ZN2de19bounce_shade_kernelILi1ELb0ELb1EEEvNS_11BounceStateENS_12BounceParamsEPK6float4' for 'sm_90a'
ptxas info    : Function properties for _ZN2de19bounce_shade_kernelILi1ELb0ELb1EEEvNS_11BounceStateENS_12BounceParamsEPK6float4
    80 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 124 registers, used 0 barriers, 80 bytes cumulative stack size
ptxas info    : Function properties for _ZN2de10cloud_callENS_3KeyENS_2V3ES1_fffPKhiiiib
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN2de20threefry_fold_kernelILi2EEEvPKiijPi' for 'sm_90a'
ptxas info    : Function properties for _ZN2de20threefry_fold_kernelILi2EEEvPKiijPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, used 0 barriers
"""
    assert cs.ptxas_entries(log) == {"bounce_shade_kernel<1,0,1>": [124, 8, 12],
                                     "threefry_fold_kernel<2>": [12, 0, 0]}


def test_bounce_instances_read_the_block_instances():
    """chip_smoke.py's names of the bounce instances: bounce_shade's BLOCK
    instances (its fifth template argument 1) under the name they had as a
    kernel of their own, bounce_shade_block, which still parses; the
    default and knob instances by their other flags."""
    cs = _chip_smoke()
    args = "EEvNS_11BounceStateENS_11EntryParamsILi1EEEPK6float4"
    funcs = {
        "_ZN2de19bounce_shade_kernelILi4ELb0ELb0ELi0ELb0E" + args: ["FADD"] * 3,
        "_ZN2de19bounce_shade_kernelILi1ELb1ELb0ELi1ELb1E" + args: ["FADD"] * 5,
        "_ZN2de25bounce_shade_block_kernelILi4ELb0ELb1ELi3E" + args: ["FADD"] * 7,
        "_ZN2de20bounce_flight_kernelILi4ELb0ELi2EEEvNS_11BounceStateE": ["FADD"] * 2,
        "_ZN2de20threefry_fold_kernelILi2EEEvPKiijPi": ["FADD"],
    }
    got = sorted(cs.bounce_instances(funcs).values())
    assert got == [("bounce_flight<L=4, 0, 2>", (0, 2), 2),
                   ("bounce_shade<L=4, 0, 0, 0>", (0, 0, 0), 3),
                   ("bounce_shade_block<L=1, 1, 0, 1>", (1, 0, 1), 5),
                   ("bounce_shade_block<L=4, 0, 1, 3>", (0, 1, 3), 7)]


def test_bounce_registers_reads_the_five_argument_default():
    """The timed default bounce_shade has five template arguments (L,
    COUNT, RATIO, OPTS, BLOCK): its spills are read, a knob or BLOCK
    instance's are not."""
    import types

    cs = _chip_smoke()
    lines = []
    for kernel, flags, spill in (("19bounce_shade", "ILi4ELb0ELb0ELi0ELb0E", 4),
                                 ("19bounce_shade", "ILi4ELb0ELb0ELi1ELb1E", 96),
                                 ("20bounce_flight", "ILi4ELb0ELi0E", 8)):
        name = f"_ZN2de{kernel}_kernel{flags}EEvNS_11BounceStateE"
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
                  "ptxas info    : Used 64 registers, used 0 barriers"]
    name = "_ZN2de20bounce_window_kernelILi4ELb0ELi0EEEvNS_11BounceStateE"
    lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
              f"ptxas info    : Function properties for {name}",
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
              "ptxas info    : Used 64 registers, used 0 barriers"]
    occ = dict(registers=64, local_bytes=0, warps_per_sm=32)
    kern = types.SimpleNamespace(ptxas_log={"bounce.cu": "\n".join(lines)},
                                 OCCUPANCY_ENTRIES=("bounce_flight", "bounce_shade",
                                                    "bounce_window"),
                                 bounce_occupancy=lambda name: occ)
    got = cs.bounce_registers(kern)
    assert {n: (r["spill_stores"], r["spill_loads"]) for n, r in got.items()} == {
        "bounce_flight": (8, 8), "bounce_shade": (4, 4), "bounce_window": (0, 0)}


def test_naive_step_sass_counts_one_step(monkeypatch):
    """The row-17 bound's step: naive_steps_kernel<2>'s body less <1>'s in
    the measurement library, so the lane's loads, stores and index, paid
    once a lane, drop out; the slow paths after EXIT are left out; a build
    without the pair fails."""
    import types

    cs = _chip_smoke()
    frame = ["S2R", "ISETP.GE.AND", "LDG.E", "LDG.E", "IMAD.WIDE"]
    step = ["FMUL", "MUFU.RCP", "FFMA", "MUFU.RSQ", "LDG.E.CONSTANT", "FADD", "FSETP.GT.AND"]
    tail = ["STG.E", "EXIT", "CALL.REL.NOINC", "EXIT", "MUFU.RCP", "RET.REL.NODEC", "BRA"]
    funcs = {"_ZN2de18naive_steps_kernelILi1EEEvPKhiiPKfS3_S3_PfPhif": frame + step + tail,
             "_ZN2de18naive_steps_kernelILi2EEEvPKhiiPKfS3_S3_PfPhif":
                 frame + step + step + ["PLOP3.LUT"] + tail}
    monkeypatch.setattr(cs, "sass_functions", lambda so: funcs)
    kern = types.SimpleNamespace(bench_library=lambda: types.SimpleNamespace(_name="b.so"))
    got = cs.naive_step_sass(kern)
    assert got["instructions"] == len(step) + 1
    assert got["pipes"]["xu"] == 2 and got["pipes"]["f32"] == 4
    assert got["ops"]["MUFU.RCP"] == 1 and "S2R" not in got["ops"]
    trips = torch.tensor([4, 0, 6], dtype=torch.int32)
    assert cs.naive_ops(torch, "intersect_land_naive", None, trips, None, step=got) == (
        10.0 * 8, 10.0 * 2, 0.0)
    monkeypatch.setattr(cs, "sass_functions", lambda so: {
        n: f for n, f in funcs.items() if "ILi2E" not in n})
    with pytest.raises(SystemExit):
        cs.naive_step_sass(kern)


def test_sass_tap_bound_counts_the_body_by_pipe():
    """The tap's operations bound reads the kernel's body up to its last
    EXIT before the division's slow-path subroutine (ending in RET), and
    times each pipe at its rate: XU (MUFU, conversions) 16, FP32 128, the
    integer ALU and IMAD 64 per SM per clock."""
    cs = _chip_smoke()
    ops = ["S2R", "MUFU.RCP", "FFMA", "FFMA", "I2F.U32", "IADD3", "IMAD", "EXIT",
           "CALL.REL.NOINC", "EXIT", "BRA", "FFMA", "MUFU.RCP", "RET.REL.NODEC", "BRA"]
    body = cs.sass_main_body(ops)
    assert body == ops[:10]
    cs.sm_clock_mhz = lambda: 1000.0
    ms, per_pipe, count = cs.sass_ops_bound(body, 132 * 16 * 1000)
    assert count == {"f32": 2, "alu": 1, "imad": 1, "xu": 2}
    assert per_pipe["xu"] == 2 * 1e-6 * 1e3 and ms == per_pipe["xu"]
    assert per_pipe["f32"] == 2 * 16 / 128 * 1e-6 * 1e3


def _stub_tap_timing(monkeypatch, cs):
    monkeypatch.setattr(cs, "_time_ms", lambda torch_, fn, reps: (fn(), 0.0))
    monkeypatch.setattr(cs, "_plain_ms", lambda torch_, fn: (fn(), 0.0))
    monkeypatch.setattr(cs, "_graph_ms", lambda torch_, fn: 0.0)
    monkeypatch.setattr(cs, "sm_clock_mhz", lambda: 1000.0)


# a nearest, a bilinear and a first-form tap body: the bilinear body the
# lower of the two bilinear ones (2 XU instructions against the first's 6)
_TAP_BODIES = {("sphere", 4, "nearest"): ["FFMA"] * 3 + ["MUFU.RCP"] + ["EXIT"],
               ("sphere", 4, "bilinear"): ["FFMA"] * 6 + ["MUFU.RCP"] * 2 + ["EXIT"],
               ("sphere", 4, "first"): ["FFMA"] * 5 + ["MUFU.RCP", "I2F.U16"] * 3 + ["EXIT"]}


@pytest.mark.parametrize("row,value,held", [
    (None, 0.0, True), (2, float("nan"), True), (3, float("inf"), True),
    (1, 2e-5, True), (2, float("nan"), False), (4, 0.5, False)])
def test_tap_case_holds_every_row_its_points_allow(monkeypatch, row, value, held):
    """chip_smoke.py's tap check passes only if every held row is finite in
    both and within TAP_ATOL of the twin: all rows at path points, on the
    edge sweep the rows whose point has finite components (the others are
    counted apart); a NaN or infinite tap where the twin is finite fails."""
    cs = _chip_smoke()
    _stub_tap_timing(monkeypatch, cs)
    g = torch.Generator().manual_seed(3)
    want = torch.rand((6, 4), generator=g)
    got = want.clone()
    if row is not None:
        got[row] = want[row] + value
    points = None if held else torch.rand((6, 3), generator=g)
    if points is not None:
        points[row, 1] = float("nan")
    rows = {}
    run = lambda: cs._tap_case(  # noqa: E731
        torch, "t", lambda b, f: got.clone(), lambda b: want, 6, _TAP_BODIES, ("sphere", 4),
        (96, 96), rows, points=points)
    if row is not None and held:
        with pytest.raises(SystemExit):
            run()
        return
    out = run()
    for form in ("nearest", "bilinear"):
        assert out[form]["nonfinite"] == 0 and out[form]["max_abs_err"] <= cs.TAP_ATOL
        if points is not None:
            assert out[form]["not_held"] == 1 and out[form]["not_held_parted"] == 1


def test_tap_case_bounds_the_bilinear_tap_by_the_lower_body(monkeypatch):
    """The bilinear tap's bound counts the lower of its body's operations
    and the first form's (the work the function needs), the first form's
    own bound kept beside it; the options rows' extra instructions a
    bilinear tap are the lower body's less the nearest one's."""
    import types

    cs = _chip_smoke()
    _stub_tap_timing(monkeypatch, cs)
    n = 4
    want = torch.zeros((n, 4))
    rows = {}
    out = cs._tap_case(torch, "t", lambda b, f: want.clone(), lambda b: want, n, _TAP_BODIES,
                       ("sphere", 4), (0, 0), rows)["bilinear"]
    assert out["bound_by"] == "operations"
    assert out["bound_ms"] == cs.sass_ops_bound(_TAP_BODIES[("sphere", 4, "bilinear")], n)[0]
    assert out["first_bound_ms"] == cs.sass_ops_bound(_TAP_BODIES[("sphere", 4, "first")], n)[0]
    assert out["first_bound_ms"] == pytest.approx(3 * out["bound_ms"])
    monkeypatch.setattr(cs, "tap_bodies", lambda kernels: _TAP_BODIES)
    assert cs.bilinear_tap_extra(types.SimpleNamespace()) == 9 - 5
    slow = dict(_TAP_BODIES)
    slow[("sphere", 4, "bilinear")] = ["FFMA"] * 20 + ["EXIT"]
    monkeypatch.setattr(cs, "tap_bodies", lambda kernels: slow)
    assert cs.bilinear_tap_extra(types.SimpleNamespace()) == 12 - 5


def test_lanes_per_warp_counts_the_ratio_trackers_lanes():
    """chip_smoke.py's tracking lanes per warp at the NEE RMO site (column
    6 of the census's trips): warps are 32 consecutive list entries, the
    last one padded; the histogram counts warps by their lanes with trips
    there, and its text bins them by the spread they allow and gives the
    share of tracking lanes in warps of at most 16."""
    cs = _chip_smoke()
    m = 32 * 3 + 5
    trips = torch.zeros((m, 7), dtype=torch.int32)
    trips[:3, 6] = 4                   # warp 0: 3 tracking lanes
    trips[32:52, 6] = 1                # warp 1: 20
    trips[32:64, 5] = 2                # another site's trips do not count
    trips[96:101, 6] = 7               # warp 3 (5 entries): 5
    hist = cs.lanes_per_warp(torch, trips)
    assert len(hist) == 33 and sum(hist) == 4
    assert hist[0] == 1 and hist[3] == 1 and hist[5] == 1 and hist[20] == 1
    text = cs.per_warp_text(hist)
    assert "0-0 1, 1-2 0, 3-4 1, 5-8 1, 9-16 0, 17-32 1" in text
    assert f"{8 / 28:.3f} of the tracking lanes in warps of at most 16" in text


def test_ratio_args_per_warp_moves_the_tracking_lanes():
    """chip_smoke.py's sparse layout for the ratio tracker's launcher: the
    tracking lanes (active, t_max >= 0, t_start < t_max), in order, c to a
    warp in its first c threads; every other thread inactive."""
    cs = _chip_smoke()
    n = 50
    t0 = torch.zeros(n)
    t1 = torch.ones(n)
    t1[3] = -1.0                       # t_max < 0: not tracking
    t0[4] = 2.0                        # t_start past t_max: not tracking
    active = torch.ones(n, dtype=torch.bool)
    active[7] = False
    keys = torch.arange(2 * n).view(n, 2)
    pos = torch.arange(3.0 * n).view(n, 3)
    ext = torch.arange(12.0 * n).view(n, 4, 3)
    out = cs.ratio_args_per_warp(torch, (keys, pos, pos, t0, t1, ext, t0, active), 4)
    lanes = [i for i in range(n) if i not in (3, 4, 7)]
    assert out[7].shape == (32 * 12,) and int(out[7].sum()) == len(lanes)
    slots = torch.nonzero(out[7]).squeeze(1)
    assert ((slots % 32) < 4).all()
    assert torch.equal(out[0][slots], keys[lanes]) and torch.equal(out[5][slots], ext[lanes])
    assert all(a.shape[0] == 32 * 12 for a in out)


def _block_rounds(trips, block, rnd, warp=32):
    """The naive march's block rounds written out lane by lane: each round,
    where that empties a warp, the block's lanes still marching packed in
    thread order onto its first threads; each warp issues its longest lane's
    steps that round, at most ``rnd`` while more lanes march than a warp
    holds."""
    issued = 0
    for b0 in range(0, len(trips), block):
        rem = list(trips[b0:b0 + block]) + [0] * (block - len(trips[b0:b0 + block]))
        while any(rem):
            live = [t for t in rem if t > 0]
            busy = sum(any(rem[w0:w0 + warp]) for w0 in range(0, block, warp))
            if -(-len(live) // warp) < busy:
                rem = live + [0] * (block - len(live))
            budget = rnd if len(live) > warp else max(live)
            take = [min(t, budget) for t in rem]
            issued += sum(max(take[w0:w0 + warp]) for w0 in range(0, block, warp))
            rem = [t - s for t, s in zip(rem, take)]
    return issued


def test_march_rounds_replays_the_block_rounds():
    """chip_smoke.py's replay of the naive march's block rounds (csrc/naive.cuh
    naive_march_block) against the rounds written out lane by lane, on
    ragged lane counts with idle lanes, short and budget-long chains; one
    thread a lane's warp-steps are each warp's longest lane's; two lanes of
    a block in two warps are packed into one; no step, no rounds."""
    cs = _chip_smoke()
    r = np.random.default_rng(3)
    for n in (1, 31, 128, 129, 1000):
        for p0 in (0.0, 0.5, 0.9):
            trips = r.choice([1, 3, 7, 9, 30, 250], size=n).astype(np.int32)
            trips[r.random(n) < p0] = 0
            simt, issued, solo = cs.march_rounds(torch, torch.from_numpy(trips))
            if not trips.any():
                assert (simt, issued, solo) == (None, 0, 0)
                continue
            assert issued == _block_rounds(trips.tolist(), cs.NAIVE_MARCH_BLOCK,
                                           cs.NAIVE_MARCH_ROUND)
            padded = np.concatenate([trips, np.zeros((-n) % 32, np.int32)])
            assert solo == int(padded.reshape(-1, 32).max(1).sum())
            assert simt == trips.sum() / (issued * 32)
    one = torch.zeros(128, dtype=torch.int32)
    one[5], one[77] = 40, 3
    assert cs.march_rounds(torch, one)[1:] == (40, 43)
    assert cs.march_rounds(torch, torch.zeros(256, dtype=torch.int32)) == (None, 0, 0)
