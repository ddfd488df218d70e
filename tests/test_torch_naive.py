"""The reference-faithful naive arm (``TraceConfig`` naive_tracking,
naive_march, naive_cloud_tracking, naive_shadow; render/tracking_naive.py)
in the port, against the JAX package on the CPU, and the port's accelerated
trackers against the port's naive twins within Monte Carlo error.

- The twins on the 4096 lanes of test_torch_tracers (rays from orbit at the
  limb and disk, rays from just above the terrain), the same keys on both
  sides: ``intersect_land_naive`` hit/miss and distance, ``delta_track_naive``
  event, interaction id and distance, ``ratio_track_naive`` transmittance,
  for the gases and the cloud. Tolerances are shares of lanes within rtol
  1e-3, as test_torch_options states them; the measured shares are in each
  test's docstring.
- One bounce at each flag on the three scenes (the 32x18 golden frame's
  bounce-0 wavefront, test_torch_options._port_bounce) against the eager
  reference's bounce on the same lanes, held to
  ``test_torch_bounce._hold_to_floors``.
- A 32x18 frame at each flag against the JAX renderer.
- The statistical tests of tests/test_tracking_equiv.py (TestCloudTrackers,
  TestRmoTrackers): the port's accelerated cloud and gas trackers against the
  port's naive twins, at the JAX tests' sizes.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.render import pathtracer as jpt
from digital_earth_tpu.render import params as jparams
from digital_earth_tpu.render import tracking_naive as jtn
from digital_earth_tpu.render.params import TraceConfig as JaxConfig
from digital_earth_tpu_torch import constants as C
from digital_earth_tpu_torch import convert
from digital_earth_tpu_torch.assets.luts import load_spectral_luts
from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.models import volume as vol
from digital_earth_tpu_torch.ops import rng
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render import tracers
from digital_earth_tpu_torch.render import tracking_naive as tn
from digital_earth_tpu_torch.render.params import NAIVE_OPTIONS, TraceConfig
from test_torch_bounce import _hold_to_floors, raw_atlas  # noqa: F401  (fixture)
from test_torch_options import _eager, _on, _port_bounce
from test_torch_options import FLORIDA, SUNSET
from test_torch_tracers import N, SCALE, T, case  # noqa: F401  (fixture)

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

APOLLO = "config - Apollo 11.txt"
FLAGS = {"naive_tracking": dict(naive_tracking=True, hero_lambdas=1),
         "naive_march": dict(naive_march=True),
         "naive_cloud_tracking": dict(naive_cloud_tracking=True),
         "naive_shadow": dict(naive_shadow=True)}
SMALL = dict(max_tracking_steps=1024, land_march_steps=128)


@pytest.mark.parametrize("flag", sorted(NAIVE_OPTIONS))
def test_trace_config_carries_the_naive_flags(flag):
    """``convert.trace_config`` carries each naive flag across with the
    reference's default; naive_tracking needs one wavelength a path."""
    assert NAIVE_OPTIONS[flag] == jparams.TraceConfig.__dataclass_fields__[flag].default
    options = FLAGS[flag]
    got = convert.trace_config(JaxConfig(**options))
    assert getattr(got, flag) is True and got == TraceConfig(**options)
    assert got.options() == {}  # the scene and march options stay at their defaults


def test_naive_tracking_needs_one_wavelength():
    with pytest.raises(ValueError):
        TraceConfig(naive_tracking=True)
    with pytest.raises(ValueError):
        TraceConfig(naive_tracking=True, hero_lambdas=4)
    with pytest.raises(ValueError):
        convert.trace_config(JaxConfig(naive_tracking=True, hero_lambdas=4))
    assert TraceConfig(naive_march=True, hero_lambdas=4).naive_march


def _share_close(a, b, rtol=1e-3):
    return np.isclose(a, b, rtol=rtol, atol=1e-7).mean()


@pytest.mark.parametrize("bilinear", [False, True])
def test_intersect_land_naive_matches_jax(case, bilinear):
    """The plain sphere march on the 4096 lanes against the reference's
    ``intersect_land_naive``. Measured, nearest and bilinear taps: hit/miss
    agreement 1.000 (0.677 of the lanes hit), hits within rtol 1e-3 0.9989;
    stated 0.99 and 0.99 (the accelerated any-hit march agrees with the
    plain one on hit/miss on 0.985 of these lanes). Without land every ray
    misses."""
    cfg = dict(bilinear_tracking=bilinear, **SMALL)
    j = np.asarray(jtn.intersect_land_naive(
        case["jatlas"].topography, jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]),
        jnp.float32(SCALE), jnp.asarray(case["active"]), JaxConfig(**cfg)))
    args = (case["tatlas"].topography, T(case["pos"]), T(case["dirs"]), torch.tensor(SCALE),
            T(case["active"]))
    trips = torch.zeros(N, dtype=torch.int32)
    t = tn.intersect_land_naive_plain(*args, TraceConfig(**cfg), trips=trips).numpy()
    assert 0.2 < (j >= 0).mean() < 0.9
    assert ((j >= 0) == (t >= 0)).mean() >= 0.99
    both = (j >= 0) & (t >= 0)
    assert _share_close(t[both], j[both]) >= 0.99
    assert torch.equal(torch.from_numpy(t), tn.intersect_land_naive(*args, TraceConfig(**cfg)))
    act = T(case["active"])
    assert bool((trips[act] >= 1).all()) and not bool(trips[~act].any())
    none = tn.intersect_land_naive(*args, TraceConfig(enable_land=False, **cfg))
    assert bool((none == -1.0).all())


# The march's edges: step caps 1, 7 and 250 (at 1 and 7 most lanes stop at
# the budget short of ten planet radii, a hit there), grazing rays over the
# terrain's shell (long chains), rays starting under the surface (a negative
# SDF), half the lanes inactive, and bilinear taps
MARCH_EDGES = ("steps_1", "steps_7", "steps_250", "grazing", "under_surface", "inactive",
               "bilinear")
MARCH_EDGE_LANES = 256


def _march_edge_inputs(case, edge):
    """(pos, dirs, active, land_march_steps, bilinear) of a march edge case,
    as numpy arrays."""
    r = np.random.default_rng(13)
    steps, bilinear = 250, edge == "bilinear"
    if edge in ("grazing", "under_surface"):
        m = MARCH_EDGE_LANES
        up = r.normal(size=(m, 3))
        up /= np.linalg.norm(up, axis=1, keepdims=True)
        other = r.normal(size=(m, 3))
        other /= np.linalg.norm(other, axis=1, keepdims=True)
        if edge == "grazing":
            # tangent to the sphere through the terrain's middle height, from
            # 300 km before the tangent point
            tang = np.cross(up, other)
            tang /= np.linalg.norm(tang, axis=1, keepdims=True)
            pos, dirs = up * (C.PLANET_R + 0.5 * SCALE) - tang * 300e3, tang
        else:
            pos, dirs = up * (C.PLANET_R - 500.0), other
        active = np.ones(m, bool)
    else:
        h = EDGE_LANES // 2
        lanes = np.concatenate([np.arange(h), N - h + np.arange(h)])
        pos, dirs, active = case["pos"][lanes], case["dirs"][lanes], case["active"][lanes]
        if edge.startswith("steps_"):
            steps = int(edge.split("_")[1])
        elif edge == "inactive":
            active = active & (r.random(lanes.size) < 0.5)
    return pos.astype(np.float32), dirs.astype(np.float32), active, steps, bilinear


# Floors of the shares of lanes (hit/miss agreement, hits within rtol 1e-3)
# per edge case; the measured shares are in the test's docstring
MARCH_EDGE_FLOORS = {"steps_1": (0.99, 0.99), "steps_7": (0.99, 0.99), "steps_250": (0.99, 0.99),
                     "grazing": (0.99, 0.99), "under_surface": (0.99, 0.99),
                     "inactive": (0.99, 0.99), "bilinear": (0.99, 0.99)}


@pytest.mark.parametrize("edge", MARCH_EDGES)
def test_intersect_land_naive_edges_match_jax(case, edge):
    """The plain sphere march on its edges against the reference's
    ``intersect_land_naive``: hit/miss agreement and the active lanes'
    distances (a hit's, a miss's -1, the negative end of a march under the
    surface) within rtol 1e-3 on every lane but a share; an inactive lane a
    miss with no step; a step cap reached, the lanes that reach it short of
    ten planet radii a hit. Measured (hit/miss, distances): steps_1 1.000,
    1.000 (0.93 of the lanes hit at the budget); steps_7 1.000, 1.000 (0.68
    at the budget); steps_250 1.000, 1.000 (0.66 hit, 0.007 at the budget);
    grazing 1.000, 0.996 (0.047 hit, each at the budget of 250 steps, one of
    those 12 hits past rtol 1e-3); under_surface 1.000, 1.000 (every lane
    ends at a negative distance after 250 steps); inactive 1.000, 1.000;
    bilinear 1.000, 0.999; stated 0.99 and 0.99."""
    pos, dirs, active, steps, bilinear = _march_edge_inputs(case, edge)
    cfg = dict(land_march_steps=steps, bilinear_tracking=bilinear)
    j = np.asarray(jtn.intersect_land_naive(
        case["jatlas"].topography, jnp.asarray(pos), jnp.asarray(dirs), jnp.float32(SCALE),
        jnp.asarray(active), JaxConfig(**cfg)))
    trips = torch.zeros(pos.shape[0], dtype=torch.int32)
    t = tn.intersect_land_naive_plain(case["tatlas"].topography, T(pos), T(dirs),
                                      torch.tensor(SCALE), T(active), TraceConfig(**cfg),
                                      trips=trips).numpy()
    trips = trips.numpy()
    floor_hit, floor_close = MARCH_EDGE_FLOORS[edge]
    assert ((j >= 0) == (t >= 0)).mean() >= floor_hit
    assert _share_close(t[active], j[active]) >= floor_close
    assert (t[~active] == -1.0).all() and not trips[~active].any()
    assert (trips[active] >= 1).all() and trips.max() <= steps
    if edge in ("steps_1", "steps_7"):
        assert ((trips == steps) & (t >= 0.0)).any()
    if edge == "grazing":
        assert trips.max() > 50


def _spans(case, species):
    pos, dirs = jnp.asarray(case["pos"]), jnp.asarray(case["dirs"])
    no_land = jnp.full((N,), -1.0)
    if species == "rmo":
        return jpt._rmo_span(pos, dirs, no_land)
    return jpt.intersect_cloud_limits(pos, dirs, no_land)


def _ext4(case, species):
    """The (n, 4) extinctions and the (n,) global majorant of ``species``:
    the hero wavelength's gases at their majorant densities, or the cloud's
    at bounce 0."""
    if species == "rmo":
        ext = case["ext"][:, 0, :]
        ext4 = np.concatenate([ext, np.zeros((N, 1), np.float32)], axis=-1)
        max_ext = vol.max_extinction_rmo(T(case["ext"][:, :1, :])).numpy()
        return ext4, max_ext
    ext_w = np.full((N,), C.CLOUDS_EXTINCT, np.float32)
    ext4 = np.zeros((N, 4), np.float32)
    ext4[:, 3] = ext_w
    return ext4, (T(ext_w) * C.CLOUDS_DENSITY).numpy()


def _trackers(case, species, fn):
    """The reference's and the port's naive tracker ``fn`` (a name) on the
    case's lanes, the same lane keys on both sides."""
    ts, tm = _spans(case, species)
    ext4, max_ext = _ext4(case, species)
    cfg = dict(**SMALL)
    j = getattr(jtn, fn)(case["jkeys"], jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]),
                         ts, tm, jnp.asarray(ext4), jnp.asarray(max_ext),
                         case["jatlas"].clouds, species, jnp.asarray(case["active"]),
                         JaxConfig(**cfg))
    args = (case["tkeys"], T(case["pos"]), T(case["dirs"]), T(ts), T(tm), T(ext4), T(max_ext),
            case["tatlas"].clouds, species, T(case["active"]), TraceConfig(**cfg))
    trips = torch.zeros(N, dtype=torch.int32)
    t = getattr(tn, f"{fn}_plain")(*args, trips=trips)
    return j, t, args, trips, np.asarray(tm) >= np.asarray(ts)


@pytest.mark.parametrize("species", ["rmo", "cloud"])
def test_delta_track_naive_matches_jax(case, species):
    """``delta_track_naive`` on the 4096 lanes against the reference's, the
    same keys: the event and interaction id on every lane but a share, and
    the distance within rtol 1e-3. Measured: events, ids and distances
    1.000 (gases and cloud); stated 0.999 and 0.99. The lanes take events of
    both kinds (gases: 0.033 absorb, 0.712 scatter; cloud: 0.002, 0.206)."""
    (je, jt, ji), (te, tt, ti), args, trips, _ = _trackers(case, species, "delta_track_naive")
    je, jt, ji = (np.asarray(x) for x in (je, jt, ji))
    te, tt, ti = (x.numpy() for x in (te, tt, ti))
    assert (je == 1).any() and (je == 2).any()
    assert (je == te).mean() >= 0.999 and (ji == ti).mean() >= 0.999
    assert _share_close(tt, jt) >= 0.99
    if species == "cloud":
        assert set(np.unique(ti[te > 0])) == {C.CLOUD_ID}
    else:
        assert set(np.unique(ti[te > 0])) <= {C.RAYLEIGH_ID, C.MIE_ID, C.OZONE_ID}
    got = tn.delta_track_naive(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, (torch.from_numpy(x) for x in (te, tt, ti))))
    assert bool((trips >= 0).all()) and int(trips.max()) > 1


@pytest.mark.parametrize("species", ["rmo", "cloud"])
def test_ratio_track_naive_matches_jax(case, species):
    """``ratio_track_naive`` on the 4096 lanes against the reference's, the
    same keys: the transmittance within rtol 1e-3. Measured 0.9998 (gases)
    and 1.000 (cloud), means within 3e-8 and 0; stated 0.99 and 1e-4."""
    j, t, args, _, spans = _trackers(case, species, "ratio_track_naive")
    j, t = np.asarray(j), t.numpy()
    assert ((t > 0.0) & (t < 1.0) & spans).any()
    assert _share_close(t, j) >= 0.99
    assert abs(t.mean() - j.mean()) < 1e-4
    assert torch.equal(tn.ratio_track_naive(*args), torch.from_numpy(t))


# ---------------------------------------------------------------------------
# The trackers on the edges of the round structure of their warp-cooperative
# steps on the card (csrc/naive.cuh naive_track_warp): the twins against the
# reference, inputs from numpy (seed 11) on test_torch_tracers' lanes
# ---------------------------------------------------------------------------

EDGES = ("max_steps_1", "max_steps_7", "max_steps_33", "transmittance_floor", "empty_spans",
         "grazing")
EDGE_LANES = 1024  # of the case's lanes: half from orbit, half near the ground
GRAZING_LANES = 64
# the grazing chords' extinctions and majorants as multiples of the real
# ones: nearly every step a null collision, so a lane takes over 1000 steps
GRAZING_EXT = {"rmo": (1e-3, 15.0), "cloud": (1e-4, 1.0)}
# the thick case's extinctions and majorants, so that transmittances fall
# below 1e-5
THICK = {"rmo": 200.0, "cloud": 40.0}


def _edge_inputs(case, species, edge):
    """(lanes of the case, pos, dirs, t_start, t_max, ext4, max_ext, active,
    max_tracking_steps) of an edge case, as numpy arrays."""
    r = np.random.default_rng(11)
    if edge == "grazing":
        lanes = np.arange(GRAZING_LANES)
        up = r.normal(size=(GRAZING_LANES, 3))
        up /= np.linalg.norm(up, axis=1, keepdims=True)
        tang = np.cross(up, r.normal(size=(GRAZING_LANES, 3)))
        tang /= np.linalg.norm(tang, axis=1, keepdims=True)
        # tangent to the sphere halfway through the slab, from 300 km before
        r_t = C.CLOUDS_LOWER_LIMIT + 0.5 * C.CLOUDS_THICKNESS
        pos = (up * r_t - tang * 300e3).astype(np.float32)
        dirs = tang.astype(np.float32)
        active = np.ones(GRAZING_LANES, bool)
    else:
        h = EDGE_LANES // 2
        lanes = np.concatenate([np.arange(h), N - h + np.arange(h)])
        pos, dirs, active = case["pos"][lanes], case["dirs"][lanes], case["active"][lanes]
    n = lanes.size
    no_land = jnp.full((n,), -1.0)
    if species == "rmo":
        ts, tm = (np.asarray(x) for x in jpt._rmo_span(jnp.asarray(pos), jnp.asarray(dirs),
                                                        no_land))
        ext = case["ext"][lanes, 0, :]
        ext4 = np.concatenate([ext, np.zeros((n, 1), np.float32)], axis=-1)
        max_ext = vol.max_extinction_rmo(T(case["ext"][lanes, :1, :])).numpy()
    else:
        ts, tm = (np.asarray(x) for x in jpt.intersect_cloud_limits(
            jnp.asarray(pos), jnp.asarray(dirs), no_land))
        ext4 = np.zeros((n, 4), np.float32)
        ext4[:, 3] = C.CLOUDS_EXTINCT
        max_ext = (T(ext4[:, 3]) * C.CLOUDS_DENSITY).numpy()
    ts, tm = ts.astype(np.float32), tm.astype(np.float32)
    steps = SMALL["max_tracking_steps"]
    if edge.startswith("max_steps_"):
        steps = int(edge.rsplit("_", 1)[1])
    elif edge == "transmittance_floor":
        ext4 = ext4 * np.float32(THICK[species])
        max_ext = max_ext * np.float32(THICK[species])
    elif edge == "empty_spans":
        # a quarter each: t_start past t_max, t_start at t_max, t_max below
        # 0, inactive; the rest as they are
        q = r.permutation(n)
        k = n // 5
        ts[q[:k]] = tm[q[:k]] + np.float32(1.0)
        ts[q[k:2 * k]] = tm[q[k:2 * k]]
        tm[q[2 * k:3 * k]] = np.float32(-1.0)
        active = active.copy()
        active[q[3 * k:4 * k]] = False
    elif edge == "grazing":
        ext_f, max_f = GRAZING_EXT[species]
        ext4 = ext4 * np.float32(ext_f)
        max_ext = max_ext * np.float32(max_f)
        steps = 4096
    return lanes, pos, dirs, ts, tm, ext4, max_ext, active, steps


def _edge_trackers(case, species, fn, edge):
    """The reference's and the twin's tracker ``fn`` on an edge case: (ref,
    twin's outputs, the twin's steps, the lanes whose span is empty or that
    are inactive)."""
    lanes, pos, dirs, ts, tm, ext4, max_ext, active, steps = _edge_inputs(case, species, edge)
    cfg = dict(SMALL, max_tracking_steps=steps)
    j = getattr(jtn, fn)(case["jkeys"][lanes], jnp.asarray(pos), jnp.asarray(dirs),
                         jnp.asarray(ts), jnp.asarray(tm), jnp.asarray(ext4), jnp.asarray(max_ext),
                         case["jatlas"].clouds, species, jnp.asarray(active), JaxConfig(**cfg))
    trips = torch.zeros(lanes.size, dtype=torch.int32)
    t = getattr(tn, f"{fn}_plain")(case["tkeys"][torch.from_numpy(lanes)], T(pos), T(dirs), T(ts),
                                   T(tm), T(ext4), T(max_ext), case["tatlas"].clouds, species,
                                   T(active), TraceConfig(**cfg), trips=trips)
    empty = ~(active & (tm >= 0.0) & (ts < tm))
    return j, t, trips, empty, ts, steps


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("species", ["rmo", "cloud"])
def test_delta_track_naive_round_edges_match_jax(case, species, edge):
    """``delta_track_naive`` on the round structure's edges against the
    reference's, the same keys: a step cap of 1, 7 or 33 reached mid-run, thick
    extinctions, empty spans and inactive lanes (no step, the event 0, t at
    t_start), grazing chords through the slab of over 1000 steps (the gases'
    1869 at most, the cloud's 1227). Events and ids equal on every lane but a
    share, distances within rtol 1e-3. Measured: events and ids 1.000 in
    every case; distances 1.000 but the cloud's thick case, 0.9990; stated
    0.99."""
    (je, jt, ji), (te, tt, ti), trips, empty, ts, steps = _edge_trackers(
        case, species, "delta_track_naive", edge)
    je, jt, ji = (np.asarray(x) for x in (je, jt, ji))
    te, tt, ti = (x.numpy() for x in (te, tt, ti))
    trips = trips.numpy()
    assert (je == te).mean() >= 0.99 and (ji == ti).mean() >= 0.99
    assert _share_close(tt, jt) >= 0.99
    assert not trips[empty].any() and (te[empty] == 0).all() and (tt[empty] == ts[empty]).all()
    assert int(trips.max()) <= steps
    if edge.startswith("max_steps_"):
        assert (trips == steps).any()
    if edge == "grazing":
        assert int(trips.max()) > 1000


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("species", ["rmo", "cloud"])
def test_ratio_track_naive_round_edges_match_jax(case, species, edge):
    """``ratio_track_naive`` on the round structure's edges against the
    reference's, the same keys: as the delta tracker's, the thick case's
    transmittances falling below 1e-5 (on 0.63 of the gases' lanes and 0.19
    of the cloud's). Transmittances within rtol 1e-3 on every lane but a
    share. Measured: 1.000 but the gases' step caps, 0.997 (1), 0.998 (7)
    and 0.999 (33); stated 0.99."""
    j, t, trips, empty, ts, steps = _edge_trackers(case, species, "ratio_track_naive", edge)
    j, t, trips = np.asarray(j), t.numpy(), trips.numpy()
    assert _share_close(t, j) >= 0.99
    assert not trips[empty].any() and (t[empty] == 1.0).all()
    assert int(trips.max()) <= steps
    if edge.startswith("max_steps_"):
        assert (trips == steps).any()
    if edge == "transmittance_floor":
        assert (t < 1e-5).any()
    if edge == "grazing":
        assert int(trips.max()) > 1000


# (scene, flag) -> (radiance, throughput) floors of the share of bounce-0
# lanes within rtol 1e-3; the measured shares are in the test's docstring
BOUNCE_FLOORS = {
    (APOLLO, "naive_tracking"): (0.97, 0.99),
    (APOLLO, "naive_march"): (0.95, 0.96),
    (APOLLO, "naive_cloud_tracking"): (0.94, 0.95),
    (APOLLO, "naive_shadow"): (0.95, 0.95),
    **{(scene, flag): (0.98, 0.99) for scene in (FLORIDA, SUNSET) for flag in FLAGS},
}
BOUNCE_FLOORS[(SUNSET, "naive_cloud_tracking")] = (0.97, 0.99)


@pytest.mark.parametrize("scene,flag", sorted(BOUNCE_FLOORS))
def test_bounce_at_naive_flag_matches_eager_reference(raw_atlas, scene, flag):  # noqa: F811
    """The port's bounce 0 at one naive flag against the eager reference's
    on the same lanes (``_hold_to_floors``). Measured shares of lanes within
    rtol 1e-3 (radiance, throughput), then the reference at the flag against
    the reference at its default (naive_tracking: at hero_lambdas=1):

    ===================  ============  ============  ============
    flag                 Apollo 11     florida       sunset
    ===================  ============  ============  ============
    naive_tracking       0.984, 0.998  0.991, 1.000  0.988, 1.000
      ref vs default     0.682, 0.840  0.156, 0.568  0.332, 0.674
    naive_march          0.969, 0.977  1.000, 1.000  0.988, 1.000
      ref vs default     0.811, 0.806  0.530, 0.542  0.854, 0.667
    naive_cloud_tracking 0.948, 0.957  1.000, 1.000  0.984, 1.000
      ref vs default     0.958, 0.951  0.950, 0.951  0.651, 0.668
    naive_shadow         0.962, 0.967  1.000, 1.000  0.988, 1.000
      ref vs default     1.000, 1.000  1.000, 1.000  1.000, 1.000
    ===================  ============  ============  ============

    Apollo's lanes part at the gas tracker's event distance, as at the
    default (test_torch_bounce). The naive shadow march does not show at
    bounce 0 on the three scenes: on these lanes it and the any-hit march
    agree on every occlusion (test_intersect_land_naive_matches_jax holds
    the march itself)."""
    options = FLAGS[flag]
    got = _port_bounce(raw_atlas, scene, options, 0)
    want = _eager(raw_atlas, scene, got["in"], options, 0)
    lanes = got["in"]["alive"]
    port, ref = _on(got["out"], lanes), _on(want, lanes)
    _hold_to_floors({"out": (port.radiance, port.throughput),
                     "class": (port.alive, port.work_class)}, ref, BOUNCE_FLOORS[(scene, flag)])


# A naive flag with an estimator option or a march floor (the estimator and
# floor instances on the card): (radiance, throughput) floors of the share of
# bounce-0 lanes within rtol 1e-3; the measured shares are in the test's
# docstring
KNOB_FLOORS = {
    "naive_tracking, fast_loop_rng": (dict(naive_tracking=True, hero_lambdas=1,
                                           fast_loop_rng=True), (0.97, 0.99)),
    "naive_march, cert_u0": (dict(naive_march=True, march_certified_floor=True,
                                  march_uncert_floor_frac=1e-6), (0.95, 0.96)),
}


@pytest.mark.parametrize("case_name", sorted(KNOB_FLOORS))
def test_bounce_at_naive_flag_with_knob_matches_eager_reference(raw_atlas, case_name):  # noqa: F811
    """Apollo 11's bounce 0 at naive_tracking with fast_loop_rng (the naive
    trackers draw threefry at every setting) and at naive_march with the
    certified floor (the naive marches have no floor) against the eager
    reference's on the same lanes (``_hold_to_floors``). Measured shares
    (radiance, throughput): naive_tracking with fast_loop_rng 0.984, 0.998;
    naive_march with cert_u0 0.969, 0.977 (each flag's alone in
    test_bounce_at_naive_flag_matches_eager_reference)."""
    options, floors = KNOB_FLOORS[case_name]
    got = _port_bounce(raw_atlas, APOLLO, options, 0)
    want = _eager(raw_atlas, APOLLO, got["in"], options, 0)
    lanes = got["in"]["alive"]
    port, ref = _on(got["out"], lanes), _on(want, lanes)
    _hold_to_floors({"out": (port.radiance, port.throughput),
                     "class": (port.alive, port.work_class)}, ref, floors)


SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


def _port_frame(scene, options):
    """The port's 32x18 spp of ``scene`` on the 64x128 atlas of seed 3."""
    from digital_earth_tpu.assets.procgen import generate_earth_textures as jax_textures
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline

    raw = jax_textures((64, 128), seed=3)
    return render_offline(load_config(os.path.join(SCENES, scene)), "cpu", spp=1,
                          image_res=(32, 18), out_path=None, atlas=build_atlas(raw, "cpu"),
                          cfg=TraceConfig(**options)).color_buffer.numpy()


def _frame(scene, options):
    """The port's 32x18 spp of ``scene`` at ``options`` and the JAX
    renderer's on the same atlas."""
    from digital_earth_tpu.app.config_io import apply_config, load_config
    from digital_earth_tpu.assets.procgen import generate_earth_textures as jax_textures
    from digital_earth_tpu.assets.textures import build_atlas as jax_build_atlas
    from digital_earth_tpu.render.renderer import Renderer as JaxRenderer

    ref = JaxRenderer(image_res=(32, 18), atlas=jax_build_atlas(jax_textures((64, 128), seed=3)),
                      tile_pixels=576, cfg=JaxConfig(**options))
    apply_config(ref, load_config(os.path.join(SCENES, scene)))
    ref.accumulate()
    return _port_frame(scene, options), np.asarray(ref.color_buffer)


# flag -> the floor of the share of pixels within rtol 1e-3 of the JAX frame
FRAME_FLOORS = {"naive_tracking": 0.96, "naive_march": 0.93, "naive_cloud_tracking": 0.92,
                "naive_shadow": 0.93}
FRAME_BUDGETS = dict(max_bounces=3, max_tracking_steps=256, land_march_steps=64)


@pytest.mark.parametrize("flag", sorted(FRAME_FLOORS))
def test_frame_at_naive_flag_matches_jax_renderer(flag):
    """One 32x18 spp of florida (3 bounces) at one naive flag against the
    JAX renderer on the same 64x128 atlas: the share of pixels within rtol
    1e-3 and the channel means within 1%. Measured shares: naive_tracking
    0.976, naive_march 0.946, naive_cloud_tracking 0.938, naive_shadow 0.944
    (floors 0.96, 0.93, 0.92, 0.93); means within 2.5e-4 of themselves. The
    port's frame at the flag's default against the same JAX frame: 0.149,
    0.474, 0.889, under each floor but naive_shadow's (0.944: the naive
    shadow march changes no pixel here, as at bounce 0)."""
    options = dict(FLAGS[flag], **FRAME_BUDGETS)
    got, want = _frame(FLORIDA, options)
    assert np.isfinite(got).all() and got.shape == want.shape
    share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= FRAME_FLOORS[flag], share
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    if flag != "naive_shadow":
        default = _port_frame(FLORIDA, {k: v for k, v in options.items() if k not in FLAGS})
        unmoved = np.isclose(default, want, rtol=1e-3, atol=1e-7).all(-1).mean()
        assert unmoved < FRAME_FLOORS[flag], unmoved


# ---------------------------------------------------------------------------
# tests/test_tracking_equiv.py's TestCloudTrackers and TestRmoTrackers: the
# port's accelerated trackers against the port's naive twins
# ---------------------------------------------------------------------------

CFG = TraceConfig(max_tracking_steps=4096)


@pytest.fixture(scope="module")
def equiv():
    """The 128x256 atlas of seed 7 and a direction with heavy cloud."""
    raw = generate_earth_textures((128, 256), seed=7)
    atlas = build_atlas(raw, "cpu")
    cl = raw["clouds"]
    ys, xs = np.where(cl > 200)
    y, x = ys[len(ys) // 2], xs[len(xs) // 2]
    h, w = cl.shape[:2]
    v = 1.0 - (y + 0.5) / h
    u = (x + 0.5) / w
    lat = (v - 0.5) * math.pi
    lon = (2 * u - 1) * math.pi
    cloudy = np.array([-math.cos(lat) * math.cos(lon), math.sin(lat),
                       math.cos(lat) * math.sin(lon)])
    return atlas, cloudy


def _keys(seed, reps):
    return rng.lane_keys(rng.prng_key(seed, "cpu"), torch.arange(reps))


def _cloud_spans(origin, direction, reps):
    o = torch.tensor(origin, dtype=torch.float32).expand(reps, 3).contiguous()
    d = torch.tensor(direction, dtype=torch.float32).expand(reps, 3).contiguous()
    ts, tm = pt.intersect_cloud_limits(o, d, torch.full((reps,), -1.0))
    return o, d, ts, tm


class TestCloudTrackers:
    def test_delta_collision_distribution(self, equiv):
        atlas, nvec = equiv
        reps = 3000
        o, d, ts, tm = _cloud_spans(nvec * (C.PLANET_R + 100.0), nvec, reps)
        ext_w = torch.full((reps,), C.CLOUDS_EXTINCT)
        act = torch.ones(reps, dtype=torch.bool)
        e_f, t_f = tracers.track_cloud(_keys(7, reps), o, d, ts, tm, ext_w, atlas.clouds, act,
                                       CFG, "delta")
        ext4 = torch.zeros((reps, 4))
        ext4[:, 3] = C.CLOUDS_EXTINCT
        e_n, t_n, _ = tn.delta_track_naive(_keys(8, reps), o, d, ts, tm, ext4,
                                           ext_w * C.CLOUDS_DENSITY, atlas.clouds, "cloud", act,
                                           CFG)
        e_f, e_n, t_f, t_n = (x.numpy() for x in (e_f, e_n, t_f, t_n))
        p_f, p_n = (e_f > 0).mean(), (e_n > 0).mean()
        se = np.sqrt(p_n * (1 - p_n) / reps) + 1e-6
        assert abs(p_f - p_n) < 5 * se + 0.01
        if (e_f > 0).any() and (e_n > 0).any():
            m_f, m_n = t_f[e_f > 0].mean(), t_n[e_n > 0].mean()
            s = t_n[e_n > 0].std() / np.sqrt((e_n > 0).sum()) + 1e-3
            assert abs(m_f - m_n) < 6 * s + 0.01 * abs(m_n)

    def test_ratio_transmittance_agreement(self, equiv):
        atlas, nvec = equiv
        reps = 1500
        # slightly tilted so the chord crosses mixed cloud coverage
        tang = np.cross(nvec, [0.0, 1.0, 0.0])
        tang = tang / np.linalg.norm(tang)
        direction = (nvec * 0.6 + tang * 0.8) / np.linalg.norm(nvec * 0.6 + tang * 0.8)
        o, d, ts, tm = _cloud_spans(nvec * (C.PLANET_R + 100.0), direction, reps)
        ext_w = torch.full((reps,), C.CLOUDS_EXTINCT)
        act = torch.ones(reps, dtype=torch.bool)
        t_f = tracers.track_cloud(_keys(42, reps), o, d, ts, tm, ext_w, atlas.clouds, act, CFG,
                                  "ratio")
        ext4 = torch.zeros((reps, 4))
        ext4[:, 3] = C.CLOUDS_EXTINCT
        t_n = tn.ratio_track_naive(_keys(43, reps), o, d, ts, tm, ext4,
                                   ext_w * C.CLOUDS_DENSITY, atlas.clouds, "cloud", act, CFG)
        f, nv = t_f.numpy(), t_n.numpy()
        se = (f.std() + nv.std()) / np.sqrt(reps) + 1e-4
        assert abs(f.mean() - nv.mean()) < 5 * se


class TestRmoTrackers:
    def _setup_rays(self, reps):
        up = np.array([0.0, 1.0, 0.0])
        # near-horizontal ray at low altitude: long optically-thick chord
        d = np.array([0.985, 0.17, 0.0])
        d = d / np.linalg.norm(d)
        o = torch.tensor(up * (C.PLANET_R + 200.0), dtype=torch.float32).expand(reps, 3)
        dd = torch.tensor(d, dtype=torch.float32).expand(reps, 3)
        o, dd = o.contiguous(), dd.contiguous()
        wl = torch.full((reps,), 550.0)
        luts = load_spectral_luts("cpu")
        ext = torch.stack([vol.spectra_extinction_rayleigh(wl), vol.spectra_extinction_mie(wl),
                           vol.spectra_extinction_ozone(wl, luts.o3_crossec)], dim=-1)
        max_ext = vol.max_extinction_rmo(ext[:, None, :])
        ts, tm = pt._rmo_span(o, dd, torch.full((reps,), -1.0))
        return o, dd, ts, tm, ext, max_ext

    def test_delta_event_distribution(self, equiv):
        atlas, _ = equiv
        reps = 3000
        o, d, ts, tm, ext, max_ext = self._setup_rays(reps)
        act = torch.ones(reps, dtype=torch.bool)
        e_f, t_f, id_f = tracers.delta_track_rmo(_keys(3, reps), o, d, ts, tm, ext, act, CFG)
        ext4 = torch.cat([ext, torch.zeros((reps, 1))], dim=-1)
        e_n, t_n, id_n = tn.delta_track_naive(_keys(4, reps), o, d, ts, tm, ext4, max_ext,
                                              atlas.clouds, "rmo", act, CFG)
        e_f, e_n = e_f.numpy(), e_n.numpy()
        for ev in (1, 2):
            p_f, p_n = (e_f == ev).mean(), (e_n == ev).mean()
            se = np.sqrt(max(p_n * (1 - p_n), 1e-6) / reps)
            assert abs(p_f - p_n) < 5 * se + 0.01, (ev, p_f, p_n)
        # species split among events
        id_f, id_n = id_f.numpy()[e_f > 0], id_n.numpy()[e_n > 0]
        h_f = np.bincount(id_f, minlength=3) / max(len(id_f), 1)
        h_n = np.bincount(id_n, minlength=3) / max(len(id_n), 1)
        np.testing.assert_allclose(h_f, h_n, atol=0.05)

    def test_ratio_transmittance_agreement(self, equiv):
        atlas, _ = equiv
        reps = 2000
        o, d, ts, tm, ext, max_ext = self._setup_rays(reps)
        act = torch.ones(reps, dtype=torch.bool)
        t_f = tracers.ratio_track_rmo(_keys(1, reps), o, d, ts, tm, ext[:, None, :], max_ext,
                                      act, CFG)[:, 0]
        ext4 = torch.cat([ext, torch.zeros((reps, 1))], dim=-1)
        t_n = tn.ratio_track_naive(_keys(2, reps), o, d, ts, tm, ext4, max_ext, atlas.clouds,
                                   "rmo", act, CFG)
        f, nv = t_f.numpy(), t_n.numpy()
        se = (f.std() + nv.std()) / np.sqrt(reps) + 1e-4
        assert abs(f.mean() - nv.mean()) < 5 * se
