"""The reference's march floors (``TraceConfig`` march_certified_floor with
march_uncert_floor_frac, and march_floor_frac_secondary) in the port, against
the JAX package on the CPU, and tests/test_tracking_equiv.py's
TestMarchEquivalence on the port's own marches.

The settings are the reference's own experiments (tools/stage_bench.py):
``cert_u0``, ``cert_u001``, ``cert25_u0``, ``floor_sec01`` and
``floor_pri05_sec005``, and march_uncert_floor_frac=1e-6 alone, which changes
nothing.

- ``convert.trace_config`` carries the three across, alone and beside the
  estimator options.
- ``tracers._march_floor``: each floor and stall threshold the float32 value
  the reference's march uses, bit for bit, with and without a secondary
  floor (which the reference multiplies in float32: one ulp from the double
  product on some widths and fractions).
- ``intersect_land`` at each setting, plain and any-hit, against the
  reference's on the 4096 lanes of test_torch_tracers: hit/miss agreement
  and the median relative distance error as test_land_march_matches_jax
  holds the default (0.98, 5e-4); on the lanes the setting moves the port
  follows the reference at the setting on at least 0.75 of them
  (test_torch_options' gates). The secondary floors at the bounce where they
  act, through the floor a primary march takes there (JAX's ``floor_frac``).
  Measured in each test's docstring.
- The certified floors on TestMarchEquivalence's skimming rays, the
  grazing population the floor can tunnel on.
- One bounce at bounces 0 and 3 against the eager reference's bounce on
  the same lanes (test_torch_options._port_bounce), held to
  ``test_torch_bounce._hold_to_floors``.
- A 32x18 frame against the JAX renderer at cert_u0 and at
  floor_pri05_sec005, and the preview at cert_u0 against the reference's
  ``march_paths``.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu import constants as JC
from digital_earth_tpu.render import raymarcher as jrm
from digital_earth_tpu.render.params import make_scene_params
from digital_earth_tpu.render import params as jparams
from digital_earth_tpu.render import pathtracer as jpt
from digital_earth_tpu.render.params import TraceConfig as JaxConfig
from digital_earth_tpu_torch import convert
from digital_earth_tpu_torch.app.config_io import load_config
from digital_earth_tpu_torch.render import raymarcher, tracers
from digital_earth_tpu_torch.render import tracking_naive as tn
from digital_earth_tpu_torch.render.params import FLOOR_OPTIONS, TraceConfig
from test_torch_estimator import KNOB_VALUES
from test_torch_naive import equiv  # noqa: F401  (fixture)
from test_torch_options import ROOT, _same_hit
from test_torch_preview import SMALL, _apollo_lanes, share_close
from test_torch_preview import atlases as preview_atlases  # noqa: F401  (fixture)
from test_torch_preview import luts  # noqa: F401  (fixture)
from test_torch_tracers import SCALE, T, case  # noqa: F401  (fixture)

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

SETTINGS = {
    "cert_u0": dict(march_certified_floor=True, march_uncert_floor_frac=1e-6),
    "cert_u001": dict(march_certified_floor=True, march_uncert_floor_frac=0.001),
    "cert25_u0": dict(march_certified_floor=True, march_floor_frac=0.25,
                      march_uncert_floor_frac=1e-6),
    "floor_sec01": dict(march_floor_frac_secondary=0.01),
    "floor_pri05_sec005": dict(march_floor_frac=0.05, march_floor_frac_secondary=0.005),
    "u0_alone": dict(march_uncert_floor_frac=1e-6),
}


# ---------------------------------------------------------------------------
# convert.trace_config and the floors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_trace_config_carries_the_march_floors(name):
    """``convert.trace_config`` carries each setting across with the
    reference's names and defaults, alone and with the estimator options
    off theirs."""
    assert FLOOR_OPTIONS == {k: jparams.TraceConfig.__dataclass_fields__[k].default
                             for k in FLOOR_OPTIONS}
    options = SETTINGS[name]
    got = convert.trace_config(JaxConfig(**options))
    assert got == TraceConfig(**options)
    for knob, value in options.items():
        assert getattr(got, knob) == value
    both = dict(options, **KNOB_VALUES)
    assert convert.trace_config(JaxConfig(**both)) == TraceConfig(**both)


@pytest.mark.parametrize("bad", [dict(march_uncert_floor_frac=0.0),
                                 dict(march_floor_frac_secondary=-0.01),
                                 dict(march_floor_frac=0.0)])
def test_trace_config_refuses_a_floor_not_above_0(bad):
    with pytest.raises(ValueError, match="above 0"):
        TraceConfig(**bad)


def _jax_floors(width, cfg: JaxConfig, bounce):
    """The reference's floors as its march computes them (pathtracer.py:
    284-288, 470-483, 1568-1578): (step floor, stall threshold, uncertified
    floor or None), float32."""
    texel_arc = math.pi * JC.PLANET_R / width
    floor_frac = cfg.march_floor_frac
    if bounce is not None and cfg.march_floor_frac_secondary is not None:
        floor_frac = jnp.where(jnp.int32(bounce) > 0, cfg.march_floor_frac_secondary,
                               cfg.march_floor_frac)
    step_floor = jnp.asarray(texel_arc * floor_frac, jnp.float32)
    uncert = texel_arc * cfg.march_uncert_floor_frac
    stall = jnp.asarray((uncert if cfg.march_certified_floor else texel_arc * floor_frac)
                        * 0.25, jnp.float32)
    return (np.float32(step_floor), np.float32(stall),
            np.float32(uncert) if cfg.march_certified_floor else None)


def _bits(x):
    return None if x is None else np.float32(x).view(np.uint32)


WIDTHS = (128, 1350, 2048, 2700, 5400, 10800, 21600)
FRACS = (1e-6, 0.001, 0.002, 0.005, 0.01, 0.05, 0.25)


@pytest.mark.parametrize("width", WIDTHS)
def test_march_floors_bit_equal_to_jax(width):
    """Each setting's floors from ``_march_floor`` for the shadow march and
    the preview (no bounce) and for the primary marches at bounces 0 and 1,
    bit-equal to the reference's float32 values; and a secondary floor at
    each fraction of FRACS, at bounces 0 and 1."""
    topo = torch.zeros((2, width, 4), dtype=torch.uint8)
    for options in SETTINGS.values():
        for bounce in (None, 0, 1):
            got = tracers._march_floor(topo, TraceConfig(**options), bounce)
            want = _jax_floors(width, JaxConfig(**options), bounce)
            assert [_bits(x) for x in got] == [_bits(x) for x in want], (options, bounce)
    for frac in FRACS:
        cfg = dict(march_floor_frac=0.005, march_floor_frac_secondary=frac)
        for bounce in (0, 1):
            got = tracers._march_floor(topo, TraceConfig(**cfg), bounce)
            want = _jax_floors(width, JaxConfig(**cfg), bounce)
            assert [_bits(x) for x in got] == [_bits(x) for x in want], (frac, bounce)


def test_secondary_floor_is_the_float32_product():
    """With a secondary floor the reference rounds the texel arc and the
    fraction to float32 and multiplies in float32, also at bounce 0, where
    the floor is otherwise the double product rounded once: over WIDTHS x
    FRACS the two part by one ulp in 10 of 49 pairs (widths 128 and 2048,
    fractions 1e-6-0.01), and the port takes the float32 product there too;
    the naive marches, which have no floor, keep the double product."""
    parted = 0
    for width in WIDTHS:
        topo = torch.zeros((2, width, 4), dtype=torch.uint8)
        for frac in FRACS:
            sec = TraceConfig(march_floor_frac=frac, march_floor_frac_secondary=frac)
            plain = TraceConfig(march_floor_frac=frac)
            got, want = tracers._march_floor(topo, sec, 0), tracers._march_floor(topo, plain, 0)
            parted += got.step_floor != want.step_floor
            assert got.step_floor == float(np.float32(math.pi * JC.PLANET_R / width)
                                           * np.float32(frac))
            naive = TraceConfig(march_floor_frac=frac, march_floor_frac_secondary=frac,
                                naive_march=True)
            assert tracers._march_floor(topo, naive, 0) == want
    assert parted == 10, parted


# ---------------------------------------------------------------------------
# intersect_land
# ---------------------------------------------------------------------------

# setting -> the bounce whose primary-march floor the march takes (None: the
# march's own floor, the shadow march's and the preview's)
MARCH_BOUNCE = {"cert_u0": None, "cert_u001": None, "cert25_u0": None, "floor_sec01": 1,
                "floor_pri05_sec005": 0, "u0_alone": None}
_jax_marches = {}


def _jax_march(case, options, any_hit, bounce=None):
    key = (tuple(sorted(options.items())), any_hit, bounce)
    if key not in _jax_marches:
        cfg = JaxConfig(**options)
        kw = {}
        if bounce is not None and cfg.march_floor_frac_secondary is not None:
            kw = dict(floor_frac=jnp.where(jnp.int32(bounce) > 0, cfg.march_floor_frac_secondary,
                                           cfg.march_floor_frac))
        _jax_marches[key] = np.asarray(jpt.intersect_land(
            case["jatlas"].topography, jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]),
            jnp.float32(SCALE), jnp.asarray(case["active"]), cfg, any_hit=any_hit, **kw))
    return _jax_marches[key]


def _port_march(topo, pos, dirs, active, options, any_hit, bounce=None):
    cfg = TraceConfig(**options)
    return tracers.intersect_land(topo, pos, dirs, torch.tensor(SCALE), active, cfg,
                                  any_hit=any_hit, floor=tracers._march_floor(topo, cfg, bounce))


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_intersect_land_at_floor_matches_jax(case, name):
    """``intersect_land`` at one setting, plain and any-hit, against the
    reference's on the 4096 lanes: hit/miss agreement 1.000 and a median
    relative distance error of 0 at every setting (stated 0.98 and 5e-4).
    Lanes the setting moves (the reference at the setting against the
    reference at the default), plain and any-hit, and the share the port
    follows: cert_u0 225 and 316, 1.000 and 1.000; cert_u001 196 and 306,
    0.995 and 0.997; cert25_u0 238 and 327, 1.000 and 0.997; floor_sec01 at
    bounce 1 230 and 235, 1.000 and 1.000; floor_pri05_sec005 at bounce 0
    264 and 383, 1.000 and 1.000 (stated 0.75). march_uncert_floor_frac
    alone moves no lane, and the port's march is the default's bit for
    bit."""
    options, bounce = SETTINGS[name], MARCH_BOUNCE[name]
    topo = case["tatlas"].topography
    args = (T(case["pos"]), T(case["dirs"]), T(case["active"]))
    for any_hit in (False, True):
        j, d = _jax_march(case, options, any_hit, bounce), _jax_march(case, {}, any_hit)
        t = _port_march(topo, *args, options, any_hit, bounce).numpy()
        assert ((j >= 0) == (t >= 0)).mean() >= 0.98
        both = (j >= 0) & (t >= 0)
        assert np.median(np.abs(t[both] - j[both]) / np.maximum(j[both], 1.0)) < 5e-4
        moved = ~_same_hit(d, j)
        if name == "u0_alone":
            assert not moved.any()
            assert torch.equal(torch.from_numpy(t), _port_march(topo, *args, {}, any_hit))
            continue
        assert moved.any()
        assert _same_hit(t, j)[moved].mean() >= 0.75, _same_hit(t, j)[moved].mean()


def _skimming_rays(n=2048, seed=1):
    """test_tracking_equiv's near-tangent rays at 2-9 km altitude: the
    phantom-hit and floor-tunnelling population."""
    r = np.random.default_rng(seed)
    up = np.array([0.0, 1.0, 0.0])
    alt = r.uniform(2e3, 9e3, n)
    az = r.uniform(0, 2 * np.pi, n)
    pitch = np.deg2rad(r.uniform(-0.3, 1.2, n))
    tang = np.stack([np.cos(az), np.zeros(n), np.sin(az)], -1)
    d = tang * np.cos(pitch)[:, None] - up[None] * np.sin(pitch)[:, None]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = (up[None] * (6371e3 + alt)[:, None]).astype(np.float32)
    return pos, d.astype(np.float32)


@pytest.mark.parametrize("name", ["cert_u0", "cert25_u0"])
def test_certified_floor_on_skimming_rays_matches_jax(case, name):
    """The certified floors on 2048 skimming rays (seed 5; 0.070 of them
    hit) against the reference's, plain: hit/miss agreement 1.000 and
    1.000, median relative distance errors 2.0e-5 and 2.1e-5 (stated 0.98
    and 5e-4); the reference at the setting parts from its default on 138
    and 139 lanes, and the port follows it on 0.819 and 0.827 of them
    (stated 0.75): on these near-tangent rays a 1e-6 floor leaves the hits
    to the stall rule, where an ulp of t decides."""
    pos, dirs = _skimming_rays(seed=5)
    n = pos.shape[0]
    jtopo = case["jatlas"].topography

    def ref(options):
        return np.asarray(jpt.intersect_land(jtopo, jnp.asarray(pos), jnp.asarray(dirs),
                                             jnp.float32(SCALE), jnp.ones(n, bool),
                                             JaxConfig(**options)))

    j, d = ref(SETTINGS[name]), ref({})
    t = _port_march(case["tatlas"].topography, T(pos), T(dirs), torch.ones(n, dtype=torch.bool),
                    SETTINGS[name], False).numpy()
    assert ((j >= 0) == (t >= 0)).mean() >= 0.98
    both = (j >= 0) & (t >= 0)
    assert np.median(np.abs(t[both] - j[both]) / np.maximum(j[both], 1.0)) < 5e-4
    moved = ~_same_hit(d, j)
    assert moved.any()
    assert _same_hit(t, j)[moved].mean() >= 0.75, _same_hit(t, j)[moved].mean()


_jax_previews = {}  # options -> the reference's preview of the Apollo lanes


@pytest.mark.parametrize("name", ["cert_u0", "cert25_u0"])
def test_march_paths_at_certified_floor_matches_jax(luts, preview_atlases, name):  # noqa: F811
    """The preview at a certified floor against the reference's
    ``march_paths`` on 2048 Apollo 11 camera lanes, held as
    test_torch_options holds it at a march option (rtol 1e-2: the jitted
    reference parts from its eager self at 1e-3). Measured shares 0.992
    (cert_u0) and 0.992 (cert25_u0), stated 0.98; means within 5.7e-5 and
    5.3e-5, stated 5e-3. cert_u0 moves none of these lanes (the port's
    preview at it is its default's bit for bit; the floor acts on grazing
    lanes); at cert25_u0 the reference parts from its default on 31 lanes
    at rtol 1e-2 and the port follows it on all of them (stated 0.9)."""
    jl, tl = luts
    jatlas, tatlas = preview_atlases
    pos, dirs, wl, tscene = _apollo_lanes(2048, 6)
    cfg = load_config(os.path.join(ROOT, "scenes", "config - Apollo 11.txt"))
    jscene = make_scene_params(cfg.sun_angle, cfg.sun_path_rot, 7800.0)
    key = np.array([0, 11], np.uint32)

    def ref(opts):
        k = tuple(sorted(opts.items()))
        if k not in _jax_previews:
            _jax_previews[k] = np.asarray(jrm.march_paths(
                jnp.asarray(key), *(jnp.asarray(x.numpy()) for x in (pos, dirs, wl)), jscene,
                jatlas, jl, JaxConfig(**SMALL, **opts)))
        return _jax_previews[k]

    def port(opts):
        return raymarcher.march_paths_plain(T(key.astype(np.int64)), pos, dirs, wl, tscene,
                                            tatlas, tl, TraceConfig(**SMALL, **opts)).numpy()

    options = SETTINGS[name]
    want, got = ref(options), port(options)
    assert np.isfinite(got).all()
    assert share_close(got, want, rtol=1e-2) >= 0.98
    assert got.mean() == pytest.approx(want.mean(), rel=5e-3)
    moved = ~np.isclose(ref({}), want, rtol=1e-2)
    if name == "cert_u0":
        assert not moved.any() and np.array_equal(got, port({}))
    else:
        assert moved.any()
        assert np.isclose(got, want, rtol=1e-2)[moved].mean() >= 0.9


# ---------------------------------------------------------------------------
# tests/test_tracking_equiv.py's TestMarchEquivalence: the port's
# accelerated march against the port's naive march
# ---------------------------------------------------------------------------

EQUIV_CFG = TraceConfig(max_tracking_steps=4096)


class TestMarchEquivalence:
    def test_camera_rays_agree(self, equiv):  # noqa: F811
        """512 camera rays from the reference test's camera at targets
        spread 3000 km about the centre: the accelerated march's hit/miss
        against the naive march's on more than 0.98 of them, the median
        relative distance error of the hits under 5e-4."""
        atlas, _ = equiv
        n = 512
        cam = np.array([35963490.0, 12765367.0, -42445899.0])
        target = np.random.default_rng(0).normal(size=(n, 3)) * 3e6
        dirs = target - cam
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        pos = T(np.broadcast_to(cam, (n, 3)).astype(np.float32))
        args = (atlas.topography, pos, T(dirs.astype(np.float32)), torch.tensor(7800.0),
                torch.ones(n, dtype=torch.bool), EQUIV_CFG)
        fast = tracers.intersect_land(*args).numpy()
        naive = tn.intersect_land_naive(*args).numpy()
        agree = (fast > 0) == (naive > 0)
        assert agree.mean() > 0.98
        both = (fast > 0) & (naive > 0)
        assert both.any()
        rel = np.abs(fast[both] - naive[both]) / naive[both]
        assert np.median(rel) < 5e-4

    def test_phantom_hits_match_reference_semantics(self, equiv):  # noqa: F811
        """On the skimming rays the naive march hits where its budget runs
        out near the surface (the reference's phantom hits); the phantom
        crawl (march_ref_phantom) invents none of them and recovers all but
        a quarter of those the march without it misses."""
        atlas, _ = equiv
        pos, dirs = _skimming_rays()
        n = pos.shape[0]
        args = (atlas.topography, T(pos), T(dirs), torch.tensor(7800.0),
                torch.ones(n, dtype=torch.bool))
        naive = tn.intersect_land_naive(*args, EQUIV_CFG).numpy()
        ph = tracers.intersect_land(*args, TraceConfig(max_tracking_steps=4096,
                                                       march_ref_phantom=True)).numpy()
        off = tracers.intersect_land(*args, TraceConfig(max_tracking_steps=4096,
                                                        march_ref_phantom=False)).numpy()
        nhit, phit, ohit = naive > 0, ph > 0, off > 0
        assert (~nhit & phit).sum() == 0
        assert (nhit & ~ohit).sum() > 0
        assert (nhit & ~phit).sum() <= 0.25 * (nhit & ~ohit).sum()

    def test_phantom_prune_threshold_provable(self, monkeypatch):
        """With the prune altitude lifted, the h = 0 crawl never phantoms on
        lines whose perigee lies above it (16-200 km) and does phantom below
        1.8 km: pruning at _PHANTOM_PRUNE_ALT is exact."""
        monkeypatch.setattr(tracers, "_PHANTOM_PRUNE_ALT", float("inf"))
        r = np.random.default_rng(3)
        n = 4096
        a = np.concatenate([r.uniform(0.0, 1.8e3, n // 2), r.uniform(16e3, 200e3, n // 2)])
        u = r.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        w = r.normal(size=(n, 3))
        d = w - np.sum(w * u, axis=-1, keepdims=True) * u
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        peri = u * (6371e3 + a)[:, None]
        s0 = r.uniform(0.0, 2.2e6, n)[:, None]
        res = tracers._phantom_crawl(
            T((peri - s0 * d).astype(np.float32)), T(d.astype(np.float32)),
            torch.ones(n, dtype=torch.bool), torch.full((n,), -1.0),
            torch.full((n,), math.inf), EQUIV_CFG).numpy()
        phantom = res > 0
        assert phantom[n // 2:].sum() == 0, "crawl phantomed above the prune threshold"
        assert phantom[: n // 2].sum() > 0

    def test_certified_floor_no_worse_than_plain_floor(self, equiv):  # noqa: F811
        """At an exaggerated floor (0.25 texel) the certified march's
        hit/miss against a near floor-free march (1e-6 texel) is at least as
        faithful as the plain floor's, on the skimming rays of seed 5."""
        atlas, _ = equiv
        pos, dirs = _skimming_rays(seed=5)
        n = pos.shape[0]
        args = (atlas.topography, T(pos), T(dirs), torch.tensor(7800.0),
                torch.ones(n, dtype=torch.bool))
        base = dict(max_tracking_steps=4096, march_ref_phantom=False)
        truth = tracers.intersect_land(*args, TraceConfig(**base, march_floor_frac=1e-6)) > 0
        plain = tracers.intersect_land(*args, TraceConfig(**base, march_floor_frac=0.25)) > 0
        cert = tracers.intersect_land(*args, TraceConfig(
            **base, march_floor_frac=0.25, march_certified_floor=True,
            march_uncert_floor_frac=1e-6)) > 0
        assert int((cert != truth).sum()) <= int((plain != truth).sum())
