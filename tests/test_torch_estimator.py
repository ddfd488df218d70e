"""The reference's estimator options (``TraceConfig`` analytic_flight with
flight_newton_iters, fast_loop_rng, nee_rr_start / nee_rr_prob,
cloud_rr_start / cloud_rr_keep, nee_off) in the port, against the JAX
package on the CPU.

- ``convert.trace_config`` carries the eight across, and the march floors
  beside them, and still refuses the packet widths the kernels are not
  built for.
- ``rng.fast_uniform`` bit for bit against the reference's, at counters
  past 2^31 and 2^32 (mod 2^32) and on edge keys.
- ``atmosphere_lut.sample_flight_distance_plain`` and
  ``tracers.sample_rmo_flight_analytic_plain`` against the reference's on a
  fan of 4096 rays from grazing to steep (tests/test_flight_analytic.py's);
  the Newton steps amplify the table's one-ulp differences, so these are
  shares of lanes, each floor just under what was measured.
- The three accelerated trackers at fast_loop_rng on the 4096 lanes of
  test_torch_tracers against the reference's, the same keys.
- One bounce per option (the 32x18 golden frame's wavefront,
  test_torch_options._port_bounce) at bounces 0 and 3 against the eager
  reference's, held to ``test_torch_bounce._hold_to_floors``; the reference
  at the option parts from the reference at the default by more than the
  floor's slack.
- A 32x18 frame with all of them but nee_off against the JAX renderer.

The statistical tests are in test_torch_estimator_stats.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu import constants as JC
from digital_earth_tpu.assets.luts import load_spectral_luts as jax_luts
from digital_earth_tpu.models import atmosphere_lut as jatm
from digital_earth_tpu.models import volume as jvol
from digital_earth_tpu.ops import math_utils as jmu
from digital_earth_tpu.ops import rng as jrng
from digital_earth_tpu.render import params as jparams
from digital_earth_tpu.render import pathtracer as jpt
from digital_earth_tpu.render.params import TraceConfig as JaxConfig
from digital_earth_tpu_torch import convert
from digital_earth_tpu_torch.models import atmosphere_lut as atm
from digital_earth_tpu_torch.models import volume as vol
from digital_earth_tpu_torch.ops import rng
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render import tracers
from digital_earth_tpu_torch.render.params import ESTIMATOR_OPTIONS, TraceConfig
from test_torch_bounce import _hold_to_floors, raw_atlas  # noqa: F401  (fixture)
from test_torch_naive import FRAME_BUDGETS, _frame
from test_torch_options import FLORIDA, SUNSET, _eager, _on, _port_bounce, _share
from test_torch_tracers import N, T, _cloud_both, _rmo_spans, case  # noqa: F401  (fixture)

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

FAST = dict(fast_loop_rng=True)


# ---------------------------------------------------------------------------
# convert.trace_config
# ---------------------------------------------------------------------------

KNOB_VALUES = {"analytic_flight": True, "flight_newton_iters": 7, "fast_loop_rng": True,
               "nee_rr_start": 2, "nee_rr_prob": 0.5, "cloud_rr_start": 3,
               "cloud_rr_keep": 0.25, "nee_off": True}


@pytest.mark.parametrize("knob", sorted(KNOB_VALUES))
def test_trace_config_carries_the_estimator_options(knob):
    """``convert.trace_config`` carries each estimator option across with
    the reference's default, alone and with the other seven off theirs."""
    assert ESTIMATOR_OPTIONS[knob] == jparams.TraceConfig.__dataclass_fields__[knob].default
    got = convert.trace_config(JaxConfig(**{knob: KNOB_VALUES[knob]}))
    assert getattr(got, knob) == KNOB_VALUES[knob]
    assert got == TraceConfig(**{knob: KNOB_VALUES[knob]})
    assert convert.trace_config(JaxConfig(**KNOB_VALUES)) == TraceConfig(**KNOB_VALUES)


@pytest.mark.parametrize("knob,value", [
    ("march_certified_floor", True), ("march_uncert_floor_frac", 1e-6),
    ("march_floor_frac_secondary", 0.002), ("hero_lambdas", 2), ("hero_lambdas", 8),
])
def test_trace_config_carries_the_march_floors_and_the_packet_widths(knob, value):
    """The march floors and the packet widths other than 1 and 4 are
    carried across (test_torch_floors.py and test_torch_widths.py hold
    them), alone and beside the estimator options."""
    assert getattr(convert.trace_config(JaxConfig(**{knob: value})), knob) == value
    assert convert.trace_config(JaxConfig(**{knob: value}, **KNOB_VALUES)) == TraceConfig(
        **{knob: value}, **KNOB_VALUES)


@pytest.mark.parametrize("bad", [dict(nee_rr_prob=0.0), dict(cloud_rr_keep=1.5),
                                 dict(flight_newton_iters=-1)])
def test_trace_config_refuses_what_the_kernels_cannot_take(bad):
    with pytest.raises(ValueError):
        TraceConfig(**bad)


# ---------------------------------------------------------------------------
# fast_uniform
# ---------------------------------------------------------------------------

EDGE_KEYS = np.array([[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], [0x80000000, 1], [1, 0x80000000],
                      [0xFFFFFFFF, 0], [0, 0xFFFFFFFF]], np.uint32)


@pytest.mark.parametrize("counter", [0, 1, 7, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1,
                                     2**32, 2**32 + 3, 2**33 + 7])
def test_fast_uniform_matches_jax_bit_for_bit(counter):
    """``rng.fast_uniform`` against the reference's ``fast_uniform`` on 512
    lane keys and six edge keys, shapes (), (4,) and (3, 4): every bit. A
    counter past 2^32 is taken mod 2^32, as the reference's uint32 cast
    takes it."""
    keys = jnp.concatenate([jrng.as_lane_keys(jax.random.PRNGKey(11), 512),
                            jnp.asarray(EDGE_KEYS)])
    tk = torch.from_numpy(np.asarray(keys).astype(np.int64))
    for shape in ((), (4,), (3, 4)):
        want = np.asarray(jrng.fast_uniform(keys, jnp.uint32(counter % 2**32), shape))
        got = rng.fast_uniform(tk, counter, shape).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert 0.0 <= got.min() and got.max() < 1.0


# ---------------------------------------------------------------------------
# The analytic flight
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fan():
    """tests/test_flight_analytic.py's 4096 rays from 400 km altitude,
    grazing limb to steep entry, at 550 nm, with both packages' inputs."""
    n = 4096
    pos = jnp.tile(jnp.array([0.0, 0.0, JC.PLANET_R + 400e3]), (n, 1))
    down = jnp.linspace(0.35, 0.999, n)
    d = jnp.stack([jnp.sqrt(1.0 - down**2), jnp.zeros(n), -down], axis=-1)
    t0, t1 = jmu.rsi(pos, d, JC.PLANET_R + JC.ATMOS_HEIGHT)
    t_start = jnp.maximum(jnp.nan_to_num(t0, nan=-1.0), 0.0)
    tl0, _ = jmu.rsi(pos, d, JC.PLANET_R)
    t_max = jnp.where(jnp.isnan(tl0), jnp.nan_to_num(t1, nan=-1.0), tl0)
    lam = jnp.full((n, 1), 550.0)
    ext = jnp.stack([jvol.spectra_extinction_rayleigh(lam), jvol.spectra_extinction_mie(lam),
                     jvol.spectra_extinction_ozone(lam, jax_luts().o3_crossec)], axis=-1)
    j = dict(pos=pos, d=d, t_start=t_start, t_max=t_max, ext=ext)
    return dict(j=j, t={k: T(v) for k, v in j.items()}, n=n)


def test_sample_flight_distance_matches_jax(fan):
    """``sample_flight_distance_plain`` against the reference's on the fan
    with one uniform a ray. Measured: collided on 0.297 of the rays, the
    same on 1.000; tau_total within rtol 1e-4 on 1.000; t within rtol 1e-4
    on 0.985 of the rays (0.949 of the colliding ones), within 1e-3 on
    1.000. Stated: 0.999, 0.999, 0.98 (0.94) and 0.999. The span's end where
    no collision lies in the span, and no span no collision."""
    j, t, n = fan["j"], fan["t"], fan["n"]
    u = jax.random.uniform(jax.random.PRNGKey(0), (n,))
    ext = j["ext"][:, 0, :]
    jt, jc, jtau = (np.asarray(x) for x in jatm.sample_flight_distance(
        u, j["pos"], j["d"], j["t_start"], j["t_max"], ext))
    tt, tc, ttau = (x.numpy() for x in atm.sample_flight_distance_plain(
        T(u), t["pos"], t["d"], t["t_start"], t["t_max"], T(ext)))
    assert 0.1 < jc.mean() < 0.9
    assert (jc == tc).mean() >= 0.999
    assert np.isclose(ttau, jtau, rtol=1e-4).mean() >= 0.999
    assert np.isclose(tt, jt, rtol=1e-4, atol=0.0).mean() >= 0.98
    both = jc & tc
    assert np.isclose(tt[both], jt[both], rtol=1e-4, atol=0.0).mean() >= 0.94
    assert np.isclose(tt, jt, rtol=1e-3, atol=0.0).mean() >= 0.999
    t_end = np.where((t["t_max"].numpy() >= 0) & (t["t_start"].numpy() < t["t_max"].numpy()),
                     t["t_max"].numpy(), t["t_start"].numpy())
    np.testing.assert_array_equal(tt[~tc], t_end[~tc])
    _, none, tau = atm.sample_flight_distance_plain(
        T(u), t["pos"], t["d"], torch.zeros(n), torch.full((n,), -1.0), T(ext))
    assert not bool(none.any()) and bool((tau == 0.0).all())


def test_sample_rmo_flight_analytic_matches_jax(fan):
    """``sample_rmo_flight_analytic_plain`` against the reference's
    ``_sample_rmo_flight_analytic`` on the fan, the same lane keys, with 5%
    of the lanes inactive. Measured: event and interaction id 1.000 of the
    lanes (0.036 absorb, 0.246 scatter), t within rtol 1e-4 0.985; stated
    0.999 and 0.98. Its steps count n_iter on each colliding lane, on no
    other."""
    j, t, n = fan["j"], fan["t"], fan["n"]
    active = np.random.default_rng(2).random(n) < 0.95
    jkeys = jrng.lane_keys(jax.random.PRNGKey(9), jnp.arange(n))
    je, jt, ji = (np.asarray(x) for x in jpt._sample_rmo_flight_analytic(
        jkeys, j["pos"], j["d"], j["t_start"], j["t_max"], j["ext"], jnp.asarray(active),
        JaxConfig(analytic_flight=True)))
    trips = torch.zeros(n, dtype=torch.int32)
    cfg = TraceConfig(analytic_flight=True)
    te, tt, ti = (x.numpy() for x in tracers.sample_rmo_flight_analytic_plain(
        rng.lane_keys(rng.prng_key(9, "cpu"), torch.arange(n)), t["pos"], t["d"],
        t["t_start"], t["t_max"], t["ext"][:, 0, :].contiguous(), T(active), cfg, trips=trips))
    assert (je == 1).any() and (je == 2).any()
    assert (je == te).mean() >= 0.999 and (ji == ti).mean() >= 0.999
    assert np.isclose(tt, jt, rtol=1e-4, atol=0.0).mean() >= 0.98
    assert not (te[~active] > 0).any()
    trips = trips.numpy()
    assert set(np.unique(trips)) == {0, cfg.flight_newton_iters}
    assert ((trips > 0) == (te > 0))[active].all()


# ---------------------------------------------------------------------------
# The trackers at fast_loop_rng
# ---------------------------------------------------------------------------


def test_rmo_delta_track_at_fast_loop_rng_matches_jax(case):
    """The gases' delta tracker at fast_loop_rng on the 4096 lanes against
    the reference's, the same keys: events 1.000, ids 1.000 of the event
    lanes, median relative distance error 0 (stated 0.99, 0.99, 1e-5, as
    at threefry's draws); the draws differ from threefry's (the events at
    fast_loop_rng part from those at the default on 0.116 of the lanes)."""
    t0, t1 = _rmo_spans(case)
    jargs = (case["jkeys"], jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]),
             jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(case["ext"]), None,
             jnp.asarray(case["active"]))
    je, jt, jid = map(np.asarray, jpt._delta_track_rmo(*jargs, JaxConfig(**FAST)))
    te, tt, tid = (x.numpy() for x in tracers.delta_track_rmo(
        case["tkeys"], T(case["pos"]), T(case["dirs"]), T(t0), T(t1),
        T(case["ext"][:, 0, :]), T(case["active"]), TraceConfig(**FAST)))
    assert (je == te).mean() >= 0.99
    assert (jid == tid)[je > 0].mean() >= 0.99
    ev = (je > 0) & (je == te)
    assert np.median(np.abs(tt[ev] - jt[ev]) / np.maximum(np.abs(jt[ev]), 1.0)) < 1e-5
    default = np.asarray(jpt._delta_track_rmo(*jargs, JaxConfig())[0])
    assert (default != je).mean() > 0.05


@pytest.mark.parametrize("k,L", [(4, 4), (1, 1)])
def test_rmo_ratio_track_at_fast_loop_rng_matches_jax(case, k, L):
    """The gases' ratio tracker at fast_loop_rng against the reference's:
    values within rtol 1e-4, atol 1e-6 on 0.9998 (K 4, L 4) and 0.9995 (K
    1, L 1) of (lane, wavelength) pairs, the mean within 3e-8 (stated 0.99
    and 1e-6, as at threefry's draws)."""
    t0, t1 = _rmo_spans(case)
    ext = np.ascontiguousarray(case["ext"][:, :L])
    j_max = np.asarray(jnp.max(jnp.sum(jnp.asarray(ext) * jpt._MAX_DENS_RMO, -1), -1))
    j = np.asarray(jpt._ratio_track_rmo(
        case["jkeys"], jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]), jnp.asarray(t0),
        jnp.asarray(t1), jnp.asarray(ext), jnp.asarray(j_max), jnp.asarray(case["active"]),
        JaxConfig(tracking_k=k, **FAST)))
    t = tracers.ratio_track_rmo(
        case["tkeys"], T(case["pos"]), T(case["dirs"]), T(t0), T(t1), T(ext),
        vol.max_extinction_rmo(T(ext)), T(case["active"]), TraceConfig(tracking_k=k, **FAST),
    ).numpy()
    assert j.min() < 0.5 < j.max()
    assert np.isclose(t, j, rtol=1e-4, atol=1e-6).mean() >= 0.99
    assert abs(t.mean() - j.mean()) < 1e-6


@pytest.mark.parametrize("mode", ["delta", "ratio"])
def test_cloud_track_at_fast_loop_rng_matches_jax(case, mode):
    """The cloud tracker at fast_loop_rng against the reference's: delta
    events on 0.9998 of the lanes (0.206 with an event, 0.037 parting from
    the default's) with a median relative distance error of 6e-8, ratio
    transmittance within rtol 1e-4 on 0.9998 and its mean within 5.3e-5
    (stated as at threefry's draws: 0.99, 1e-5, 0.99 and 1e-3)."""
    (j, args) = _cloud_both(case, mode)
    cfg = TraceConfig(**FAST)
    pos, dirs = jnp.asarray(case["pos"]), jnp.asarray(case["dirs"])
    cs, cm = jpt.intersect_cloud_limits(pos, dirs, jnp.full((N,), -1.0))
    jf = jpt._track_cloud(case["jkeys"], pos, dirs, cs, cm, jnp.asarray(args[5].numpy()), None,
                          case["jatlas"].clouds, jnp.asarray(case["active"]), JaxConfig(**FAST),
                          mode=mode)
    got = tracers.track_cloud(*args[:8], cfg, mode)
    if mode == "delta":
        (je, jt), (te, tt) = map(np.asarray, jf), (x.numpy() for x in got)
        assert (je > 0).mean() > 0.05
        assert (je == te).mean() >= 0.99
        ev = (je > 0) & (je == te)
        assert np.median(np.abs(tt[ev] - jt[ev]) / np.maximum(jt[ev], 1.0)) < 1e-5
        assert (np.asarray(j[0]) != je).mean() > 0.0  # not threefry's stream
    else:
        jf, t = np.asarray(jf), got.numpy()
        assert abs(t.mean() - jf.mean()) < 1e-3
        assert np.isclose(t, jf, rtol=1e-4, atol=1e-6).mean() >= 0.99


# ---------------------------------------------------------------------------
# One bounce at each option
# ---------------------------------------------------------------------------

# (scene, bounce, label, options) -> (radiance, throughput) floors of the
# share of lanes within rtol 1e-3; the measured shares are in the docstring
BOUNCE_CASES = {
    (SUNSET, 0, "analytic_flight"): ((0.93, 0.96), dict(analytic_flight=True)),
    (SUNSET, 3, "analytic_flight"): ((0.99, 0.99), dict(analytic_flight=True)),
    (SUNSET, 0, "fast_loop_rng"): ((0.98, 0.99), FAST),
    (SUNSET, 3, "fast_loop_rng"): ((0.99, 0.98), FAST),
    (FLORIDA, 0, "nee_rr"): ((0.99, 0.99), dict(nee_rr_prob=0.5, nee_rr_start=-1)),
    (FLORIDA, 3, "nee_rr"): ((0.99, 0.99), dict(nee_rr_prob=0.5, nee_rr_start=2)),
    (SUNSET, 0, "cloud_rr"): ((0.98, 0.99), dict(cloud_rr_keep=0.5, cloud_rr_start=0)),
    (SUNSET, 3, "cloud_rr"): ((0.99, 0.99), dict(cloud_rr_keep=0.5, cloud_rr_start=3)),
    (FLORIDA, 0, "nee_off"): ((0.99, 0.99), dict(nee_off=True)),
    (FLORIDA, 3, "nee_off"): ((0.99, 0.99), dict(nee_off=True)),
}
_eager_default = {}


@pytest.mark.parametrize("scene,bounce,label", list(BOUNCE_CASES))
def test_bounce_at_estimator_option_matches_eager_reference(raw_atlas, scene, bounce,  # noqa: F811
                                                            label):
    """The port's bounce at one estimator option against the eager
    reference's on the lanes entering it (shares of lanes within rtol 1e-3,
    radiance and throughput; then the reference at the option against the
    reference at the default, radiance, throughput and liveness):

    ===============  =========  ============  ====================
    option           lanes      port vs ref   ref vs default
    ===============  =========  ============  ====================
    analytic_flight  sunset 0   0.941, 0.970  0.613, 0.578, 0.957
                     sunset 3   1.000, 0.996  0.846, 0.738, 0.900
    fast_loop_rng    sunset 0   0.991, 1.000  0.467, 0.351, 0.946
                     sunset 3   1.000, 0.991  0.791, 0.268, 0.891
    nee_rr 0.5       florida 0  1.000, 1.000  0.446, 1.000, 1.000
                     florida 3  1.000, 1.000  0.451, 1.000, 1.000
    cloud_rr 0.5     sunset 0   0.988, 1.000  1.000, 0.865, 0.861
                     sunset 3   1.000, 1.000  1.000, 0.868, 0.879
    nee_off          florida 0  1.000, 1.000  0.177, 1.000, 1.000
                     florida 3  1.000, 1.000  0.441, 1.000, 1.000
    ===============  =========  ============  ====================

    The roulettes act past their start bounce (nee_rr_start -1 and 2, so
    that the NEE roulette acts at bounces 0 and 3; cloud_rr_start 0 and 3).
    The analytic flight's lanes part where the two packages' table lookups
    differ by an ulp, which its Newton steps amplify in the event distance
    (test_sample_flight_distance_matches_jax)."""
    floors, options = BOUNCE_CASES[(scene, bounce, label)]
    got = _port_bounce(raw_atlas, scene, options, bounce)
    want = _eager(raw_atlas, scene, got["in"], options, bounce)
    lanes = got["in"]["alive"]
    port, ref = _on(got["out"], lanes), _on(want, lanes)
    _hold_to_floors({"out": (port.radiance, port.throughput),
                     "class": (port.alive, port.work_class)}, ref, floors)
    if (scene, bounce) not in _eager_default:
        _eager_default[(scene, bounce)] = _eager(raw_atlas, scene, got["in"], {}, bounce)
    default = _on(_eager_default[(scene, bounce)], lanes)
    same = min(_share(ref.radiance, default.radiance),
               _share(ref.throughput, default.throughput),
               float((np.asarray(ref.alive) == np.asarray(default.alive)).mean()))
    assert 1.0 - same > 1.0 - min(floors), same


def test_census_counts_the_analytic_flight_steps(raw_atlas):  # noqa: F811
    """At analytic_flight the twin's census counts the Newton steps at the
    RMO column: flight_newton_iters on each lane whose flight collides in
    its span, 0 on the others; the other columns as at delta tracking."""
    got = _port_bounce(raw_atlas, SUNSET, dict(analytic_flight=True, flight_newton_iters=9), 0)
    scene, atlas, luts, cfg = got["args"]
    s = got["in"]
    lanes = s["alive"]
    st = pt.TraceState(**{k: v[lanes].clone() for k, v in s.items()})
    trips = torch.zeros((st.pos.shape[0], pt.kernels.BOUNCE_SITES), dtype=torch.int32)
    out = pt.run_bounce_plain(st, 0, scene, atlas, luts, cfg, trips=trips)
    rmo = trips[:, pt.CENSUS_SITES.index("rmo")].numpy()
    assert set(np.unique(rmo)) == {0, 9}
    assert (rmo == 9).mean() > 0.05
    assert torch.equal(out.radiance, _on(got["out"], lanes).radiance)


# ---------------------------------------------------------------------------
# A frame with all of them but nee_off
# ---------------------------------------------------------------------------

ALL_BUT_NEE_OFF = dict(analytic_flight=True, flight_newton_iters=10, fast_loop_rng=True,
                       nee_rr_prob=0.5, nee_rr_start=0, cloud_rr_keep=0.5, cloud_rr_start=1)
FRAME_FLOOR = 0.90


def test_frame_at_all_estimator_options_matches_jax_renderer():
    """One 32x18 spp of sunset (3 bounces) with every estimator option but
    nee_off against the JAX renderer on the same 64x128 atlas: the share of
    pixels within rtol 1e-3 (measured 0.908, floor 0.90) and the channel
    means within 1% (measured 0.26%). The port's frame at the default
    config against the same JAX frame: 0.384, under the floor."""
    options = dict(ALL_BUT_NEE_OFF, **FRAME_BUDGETS)
    got, want = _frame(SUNSET, options)
    assert np.isfinite(got).all() and got.shape == want.shape
    share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= FRAME_FLOOR, share
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    from test_torch_naive import _port_frame

    default = _port_frame(SUNSET, FRAME_BUDGETS)
    unmoved = np.isclose(default, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert unmoved < FRAME_FLOOR, unmoved
