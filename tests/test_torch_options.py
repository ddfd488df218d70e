"""The reference's seven scene and march options (``TraceConfig``
enable_clouds, enable_land, bilinear_tracking, lazy_march,
march_exact_ocean, march_ref_phantom, march_stall_patience) in the port,
against the JAX package on the CPU.

Each case is chosen where the option shows, and asserts that it does: the
reference at the option must part from the reference at the default by more
than the case's slack (one minus its floor), so a port that ignored the
option would fail its floor.

- One bounce per option (the 32x18 golden frame's wavefront on the 64x128
  procedural atlas, seed 3, test_torch_bounce.KW): the port's bounce
  against the eager reference's on the same lanes, held to
  ``test_torch_bounce._hold_to_floors``. Measured shares of lanes within
  rtol 1e-3 (radiance, throughput), then the reference at the option
  against the reference at the default:

  ============================  ========  ================  ================
  option                        lanes     port vs ref       ref vs default
  ============================  ========  ================  ================
  enable_clouds=False           sunset 0  0.993, 1.000      0.719, 0.644
  enable_land=False             florida 0 1.000, 1.000      0.535, 0.535
  bilinear_tracking=True        florida 0 0.998, 0.998      0.932, 0.939
  lazy_march=False              sunset 0  0.953, 0.995      0.903, 0.891
  march_exact_ocean=False       florida 1 0.998, 0.996      0.979, 0.964
  march_ref_phantom=False       sunset 0  0.988, 1.000      0.844, 1.000
  march_stall_patience=0        sunset 0  0.988, 1.000      0.845, 0.689
  ============================  ========  ================  ================

  The exact ocean root does not show at bounce 0 on any of the three scenes
  (the reference at the option equals the default on every lane: a camera
  ray's next probe after a zero-mip skip lands on the base sphere and
  converges there), so its case is bounce 1 of florida, whose surface
  bounces graze the ocean. The phantom crawl moves 2 of Apollo 11's 576
  bounce-0 lanes (0.0035, under its floor's slack of 0.05) and 15.6% of
  sunset's, whose shadow rays toward the low sun skim the limb, so its case
  is sunset. sunset's march-first lanes part where the Apollo lanes of
  test_torch_bounce part (ROADMAP C #3): every lane's outcome agrees; given
  the same land hit the port's flight stage is within 1e-6 of the
  reference's own ``sample_interaction`` on 0.95 of the event lanes, and on
  the parting scatter lanes the port lands within 1e-5 of that stage on
  0.96 of them, the reference's bounce on 0.85.
- lazy_march=False: the twin's census runs the march at its first site
  (``CENSUS_SITES`` pre_march) for every live lane that meets the displaced
  surface's bounding sphere, and never after the flight.
- ``intersect_land`` at bilinear_tracking=True and at each march knob,
  plain and any-hit, against the reference's ``intersect_land``: hit/miss
  agreement 1.000 and a median relative distance error of 0 (7e-8 without
  the ocean root) on the 4096 lanes of test_torch_tracers; stated 0.98 and
  5e-4 as there. ``track_cloud`` at bilinear_tracking=True against
  ``_track_cloud``: delta events 0.9995 (0.985 between the reference at the
  option and at the default), ratio transmittance 0.999 within rtol 1e-4
  (0.969).
- The preview (``march_paths``) at enable_land=False and at
  bilinear_tracking=True against the reference's ``march_paths``.
- One whole frame (48x27, 1 spp) with all seven at non-default values on
  the three scenes against the JAX renderer, as test_torch_render.py holds
  the reference's estimator. Without land and clouds the other five have
  nothing to act on, so the frame is the gases' alone; the five that act on
  land and clouds are held together, with land and clouds on, on florida
  and sunset. Each frame's floor is one that the port's frame at the
  default config misses.
- A (4, 1) mesh bit-equal to the Renderer at options, as test_torch_mesh.py
  holds the default.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu import constants as JC
from digital_earth_tpu.assets.luts import load_spectral_luts as jax_luts
from digital_earth_tpu.assets.textures import build_atlas as jax_build_atlas
from digital_earth_tpu.render import pathtracer as jpt
from digital_earth_tpu.render import raymarcher as jrm
from digital_earth_tpu.render.params import TraceConfig as JaxConfig
from digital_earth_tpu.render.params import make_scene_params
from digital_earth_tpu_torch.app.config_io import load_config
from digital_earth_tpu_torch.app.viewer import render_offline
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.ops import math_utils as mu
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render import raymarcher, tracers
from digital_earth_tpu_torch.render.params import SCENE_OPTIONS, TraceConfig
from test_torch_bounce import KW, _hold_to_floors, raw_atlas  # noqa: F401  (fixture)
from test_torch_mesh import _mesh, _single
from test_torch_mesh import atlases as mesh_atlases  # noqa: F401  (fixture)
from test_torch_preview import SMALL, _apollo_lanes, share_close
from test_torch_preview import atlases as preview_atlases  # noqa: F401  (fixture)
from test_torch_preview import luts  # noqa: F401  (fixture)
from test_torch_tracers import N, SCALE, T, case  # noqa: F401  (fixture)

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUNSET, FLORIDA = "config - sunset hurricane.txt", "config - florida.txt"
FIELDS = ("pos", "direction", "wavelength", "lambda_pdf", "throughput", "radiance", "w_mis",
          "alive", "primary_miss", "work_class", "rng")

# (scene, bounce, option, value) -> (radiance, throughput) floors of the share
# of lanes within rtol 1e-3 (the measured shares are in the docstring)
BOUNCE_FLOORS = {
    (SUNSET, 0, "enable_clouds", False): (0.98, 0.99),
    (FLORIDA, 0, "enable_land", False): (0.99, 0.99),
    (FLORIDA, 0, "bilinear_tracking", True): (0.99, 0.99),
    (SUNSET, 0, "lazy_march", False): (0.94, 0.99),
    (FLORIDA, 1, "march_exact_ocean", False): (0.99, 0.99),
    (SUNSET, 0, "march_ref_phantom", False): (0.98, 0.99),
    (SUNSET, 0, "march_stall_patience", 0): (0.98, 0.99),
}
_eager_default = {}  # (scene, bounce) -> (the lanes' input, the reference's default bounce)


def _port_bounce(raw_atlas, scene, options, bounce):
    """The port's bounce ``bounce`` of ``scene``'s 32x18 frame at ``KW``
    (``bounce + 1`` bounces) and ``options``: the full state before and
    after it, and run_bounce's scene, atlas, luts and config."""
    captured = {}
    run_bounce = pt.run_bounce

    def keep(st, idx, b, *args):
        if b == bounce:
            captured["in"] = {f: getattr(st, f).clone() for f in FIELDS}
            captured["args"] = args[:4]
        run_bounce(st, idx, b, *args)
        if b == bounce:
            captured["out"] = {f: getattr(st, f).clone() for f in FIELDS}

    pt.run_bounce = keep
    try:
        render_offline(load_config(os.path.join(ROOT, "scenes", scene)), "cpu", spp=1,
                       image_res=(32, 18), out_path=None, atlas=build_atlas(raw_atlas, "cpu"),
                       seed=0, cfg=TraceConfig(**dict(KW, max_bounces=bounce + 1), **options))
    finally:
        pt.run_bounce = run_bounce
    return captured


def _eager(raw_atlas, scene, state, options, bounce):
    """The eager reference's bounce ``bounce`` at ``options`` from the port's
    full state ``state`` (its lanes' keys and values)."""
    cfg = load_config(os.path.join(ROOT, "scenes", scene))
    st = jpt.TraceState(**{k: jnp.asarray(v.numpy().astype(np.uint32) if k == "rng" else v.numpy())
                           for k, v in state.items()})
    return jpt.run_bounces(st, make_scene_params(cfg.sun_angle, cfg.sun_path_rot),
                           jax_build_atlas(raw_atlas), jax_luts(),
                           JaxConfig(**dict(KW, max_bounces=bounce + 1), **options),
                           bounce, bounce + 1)


def _on(state, lanes):
    """(radiance, throughput) and (alive, work_class) of ``lanes``, as
    ``_hold_to_floors`` reads them."""
    get = (lambda k: state[k]) if isinstance(state, dict) else (
        lambda k: torch.from_numpy(np.array(getattr(state, k))))
    return SimpleNamespace(**{k: get(k)[lanes] for k in FIELDS[4:10]})


def _share(a, b):
    return np.isclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-7).all(-1).mean()


@pytest.mark.parametrize("scene,bounce,option,value", list(BOUNCE_FLOORS))
def test_bounce_at_option_matches_eager_reference(raw_atlas, scene, bounce, option, value):
    """The port's bounce at one option against the eager reference's on the
    lanes entering it; the reference at the option parts from the reference
    at the default on more lanes than the radiance floor leaves."""
    floors = BOUNCE_FLOORS[(scene, bounce, option, value)]
    got = _port_bounce(raw_atlas, scene, {option: value}, bounce)
    want = _eager(raw_atlas, scene, got["in"], {option: value}, bounce)
    lanes = got["in"]["alive"]
    if (scene, bounce) not in _eager_default:
        _eager_default[(scene, bounce)] = (got["in"], _eager(raw_atlas, scene, got["in"], {},
                                                             bounce))
    state, default = _eager_default[(scene, bounce)]
    assert all(torch.equal(state[k], got["in"][k]) for k in FIELDS)  # the same lanes
    port, ref = _on(got["out"], lanes), _on(want, lanes)
    _hold_to_floors({"out": (port.radiance, port.throughput),
                     "class": (port.alive, port.work_class)}, ref, floors)
    parted = 1.0 - _share(ref.radiance, _on(default, lanes).radiance)
    assert parted > 1.0 - floors[0], parted


def test_march_first_census(raw_atlas):
    """lazy_march=False: the twin marches every live lane that meets the
    bounding sphere at the first census site, before the flight, and no
    lane after it; on the march's own schedule (the default) camera rays
    above the cloud slab never march first."""
    got = _port_bounce(raw_atlas, SUNSET, {}, 0)
    scene, atlas, luts, cfg = got["args"]
    s = got["in"]
    lanes = s["alive"]
    bound_near, bound_far = mu.rsi(s["pos"], s["direction"],
                                   JC.PLANET_R + scene.land_height_scale)
    meets = lanes & (bound_far > 0.0)
    assert 0 < int(meets.sum()) < int(lanes.sum())
    meets = meets[lanes]
    for options in ({"lazy_march": False}, {}):
        st = pt.TraceState(**{k: v.clone() for k, v in s.items()})
        trips = torch.zeros((int(lanes.sum()), len(pt.CENSUS_SITES)), dtype=torch.int32)
        pt.run_bounce_plain(st.take(lanes), 0, scene, atlas, luts,
                            TraceConfig(**KW, **options), trips=trips)
        first, after = trips[:, 0], trips[:, 3]
        if options:
            assert bool((first[meets] >= 1).all()) and not bool(first[~meets].any())
            assert not bool(after.any())
        else:
            assert not bool(first.any()) and bool(after.any())


def _same_hit(a, b):
    """Lanes where march results ``a`` and ``b`` agree: both miss, or both
    hit within rtol 1e-3."""
    hit = b >= 0
    return ((a >= 0) == hit) & (~hit | (np.abs(a - b) <= 1e-3 * np.maximum(np.abs(b), 1.0)))


_jax_marches = {}  # (options, any_hit) -> the reference's march on the case's lanes


def _jax_march(case, options, any_hit):
    key = (tuple(sorted(options.items())), any_hit)
    if key not in _jax_marches:
        _jax_marches[key] = np.asarray(jpt.intersect_land(
            case["jatlas"].topography, jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]),
            jnp.float32(SCALE), jnp.asarray(case["active"]), JaxConfig(**options),
            any_hit=any_hit))
    return _jax_marches[key]


# the march's options: any hit and plain, each against the reference's march
MARCH_OPTIONS = [dict(bilinear_tracking=True), dict(march_exact_ocean=False),
                 dict(march_ref_phantom=False), dict(march_stall_patience=0)]


@pytest.mark.parametrize("options", MARCH_OPTIONS)
def test_intersect_land_at_option_matches_jax(case, options):
    """``intersect_land`` at one march option, plain and any-hit, against the
    reference's on the 4096 lanes of test_torch_tracers: hit/miss agreement
    and the median distance error as test_land_march_matches_jax holds the
    default; on the lanes the option moves (the reference at the option and
    at the default not both missing or both hitting within rtol 1e-3) the
    port follows the reference at the option on at least 0.75 of them.
    Measured, plain and any-hit: bilinear taps 230 and 222 moved lanes,
    followed on 0.996 and 1.000; no ocean root 35 and 41, 0.80 and 0.88 (its
    hits converge on the relative epsilon, a floor step apart where a probe
    rounds across it); no phantom crawl 30 and 2, 1.000; patience 0 942 and
    921, 1.000."""
    act = case["active"]
    for any_hit in (False, True):
        j, d = _jax_march(case, options, any_hit), _jax_march(case, {}, any_hit)
        t = tracers.intersect_land(case["tatlas"].topography, T(case["pos"]), T(case["dirs"]),
                                   torch.tensor(SCALE), T(act), TraceConfig(**options),
                                   any_hit=any_hit).numpy()
        assert ((j >= 0) == (t >= 0)).mean() >= 0.98
        both = (j >= 0) & (t >= 0)
        assert np.median(np.abs(t[both] - j[both]) / np.maximum(j[both], 1.0)) < 5e-4
        moved = ~_same_hit(d, j)
        assert moved.any()
        assert _same_hit(t, j)[moved].mean() >= 0.75, _same_hit(t, j)[moved].mean()


def test_intersect_land_without_land(case):
    """enable_land=False: every ray misses, as the reference's."""
    got = tracers.intersect_land(case["tatlas"].topography, T(case["pos"]), T(case["dirs"]),
                                 torch.tensor(SCALE), T(case["active"]),
                                 TraceConfig(enable_land=False))
    assert bool((got == -1.0).all())


@pytest.mark.parametrize("mode", ["delta", "ratio"])
def test_track_cloud_bilinear_matches_jax(case, mode):
    """``track_cloud`` with bilinear taps against ``_track_cloud``; the
    reference's bilinear taps part from its nearest ones on more lanes than
    the port parts from the reference."""
    pos, dirs = jnp.asarray(case["pos"]), jnp.asarray(case["dirs"])
    cs, cm = jpt.intersect_cloud_limits(pos, dirs, jnp.full((N,), -1.0))
    ext_w = np.full((N,), JC.CLOUDS_EXTINCT, np.float32)

    def both(opts):
        j = jpt._track_cloud(case["jkeys"], pos, dirs, cs, cm, jnp.asarray(ext_w), None,
                             case["jatlas"].clouds, jnp.asarray(case["active"]),
                             JaxConfig(**opts), mode=mode)
        return j, tracers.track_cloud(case["tkeys"], T(case["pos"]), T(case["dirs"]), T(cs),
                                      T(cm), T(ext_w), case["tatlas"].clouds, T(case["active"]),
                                      TraceConfig(**opts), mode)

    (j, t), (d, _) = both(dict(bilinear_tracking=True)), both({})
    if mode == "delta":
        (je, jt), (te, tt), (de, _) = ([np.asarray(x) for x in p] for p in (j, t, d))
        assert (je == te).mean() >= 0.999 and (je == de).mean() < 0.999
        ev = (je > 0) & (je == te)
        assert np.median(np.abs(tt[ev] - jt[ev]) / np.maximum(jt[ev], 1.0)) < 1e-5
    else:
        j, t, d = np.asarray(j), t.numpy(), np.asarray(d)
        assert abs(t.mean() - j.mean()) < 1e-3
        assert np.isclose(t, j, rtol=1e-4, atol=1e-6).mean() >= 0.99
        assert np.isclose(d, j, rtol=1e-4, atol=1e-6).mean() < 0.99


@pytest.mark.parametrize("options", [dict(enable_land=False), dict(bilinear_tracking=True)])
def test_march_paths_at_option_matches_jax(luts, preview_atlases, options):  # noqa: F811
    """The preview at a march option against the reference's ``march_paths``
    on 2048 Apollo 11 camera lanes. The jitted reference parts from its
    eager self on 0.088 of these lanes at rtol 1e-3 (test_torch_preview),
    so the lanes are held at rtol 1e-2: measured shares 0.990 (no land) and
    0.992 (bilinear taps), stated 0.98; means within 2.2e-3 and 4.8e-5,
    stated 5e-3. On the lanes the option moves at rtol 1e-2 (the reference
    at the default against the reference at the option: 1698 and 15 lanes)
    the port follows the reference at the option on 0.996 and 1.000 of
    them, stated 0.9, where the port at the default follows on 0.000 and
    0.067."""
    jl, tl = luts
    jatlas, tatlas = preview_atlases
    pos, dirs, wl, tscene = _apollo_lanes(2048, 6)
    cfg = load_config(os.path.join(ROOT, "scenes", "config - Apollo 11.txt"))
    jscene = make_scene_params(cfg.sun_angle, cfg.sun_path_rot, 7800.0)
    key = np.array([0, 11], np.uint32)

    def ref(opts):
        return np.asarray(jrm.march_paths(jnp.asarray(key), *(jnp.asarray(x.numpy()) for x in
                                                             (pos, dirs, wl)),
                                          jscene, jatlas, jl, JaxConfig(**SMALL, **opts)))

    want, default = ref(options), ref({})
    got = raymarcher.march_paths_plain(T(key.astype(np.int64)), pos, dirs, wl, tscene, tatlas,
                                       tl, TraceConfig(**SMALL, **options)).numpy()
    assert np.isfinite(got).all()
    assert share_close(got, want, rtol=1e-2) >= 0.98
    assert got.mean() == pytest.approx(want.mean(), rel=5e-3)
    moved = ~np.isclose(default, want, rtol=1e-2)
    assert moved.any()
    assert np.isclose(got, want, rtol=1e-2)[moved].mean() >= 0.9


# every option off its default; the five that act on land and clouds off
# their defaults with land and clouds on
ALL_SEVEN = {name: (not default) if isinstance(default, bool) else 0
             for name, default in SCENE_OPTIONS.items()}
MARCH_FIVE = dict(bilinear_tracking=True, lazy_march=False, march_exact_ocean=False,
                  march_ref_phantom=False, march_stall_patience=0)
# scene -> the floor of the share of pixels within rtol 1e-3 of the JAX frame
FRAME_FLOORS = {"config - Apollo 11.txt": 0.94, FLORIDA: 0.89, SUNSET: 0.74}
FIVE_FLOORS = {FLORIDA: 0.92, SUNSET: 0.77}


def _hold_frame_to_jax(scene, options, floor):
    """One 48x27 spp at ``options`` against the JAX renderer on the same
    256x512 atlas (test_torch_render.py's), to ``floor``; the port's frame at
    the default config falls under the floor against the same JAX frame."""
    from digital_earth_tpu.app.config_io import apply_config
    from digital_earth_tpu.assets.procgen import generate_earth_textures
    from digital_earth_tpu.render.renderer import Renderer as JaxRenderer

    raw = generate_earth_textures((256, 512), seed=7)
    cfg = load_config(os.path.join(ROOT, "scenes", scene))
    ref = JaxRenderer(image_res=(48, 27), atlas=jax_build_atlas(raw), tile_pixels=1296,
                      cfg=JaxConfig(**options))
    apply_config(ref, cfg)
    ref.accumulate()
    want = np.asarray(ref.color_buffer)
    tatlas = build_atlas(raw, "cpu")
    got, default = (render_offline(cfg, "cpu", spp=1, image_res=(48, 27), out_path=None,
                                   atlas=tatlas, cfg=TraceConfig(**o)).color_buffer.numpy()
                    for o in (options, {}))
    assert np.isfinite(got).all() and got.shape == want.shape
    share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= floor, share
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.05)
    unmoved = np.isclose(default, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert unmoved < floor, unmoved


@pytest.mark.parametrize("scene", sorted(FRAME_FLOORS))
def test_all_seven_options_match_jax_renderer(scene):
    """One 48x27 spp with all seven options off their defaults against the
    JAX renderer. Measured shares of pixels within rtol 1e-3: Apollo 11
    0.951, florida 0.907, sunset 0.762 (floors 0.94, 0.89, 0.74); channel
    means within 0.035, 0.003, 0.001 (stated 0.05). The port's frame at the
    default config against the same JAX frame: 0.725, 0.299, 0.299, each
    under its floor."""
    _hold_frame_to_jax(scene, ALL_SEVEN, FRAME_FLOORS[scene])


@pytest.mark.parametrize("scene", sorted(FIVE_FLOORS))
def test_march_options_with_land_and_clouds_match_jax_renderer(scene):
    """One 48x27 spp with bilinear taps, march first and the three march
    knobs off their defaults, land and clouds on, against the JAX renderer.
    Measured shares of pixels within rtol 1e-3: florida 0.941, sunset 0.796
    (floors 0.92, 0.77); channel means within 0.004 and 0.008 (stated 0.05).
    The port's frame at the default config against the same JAX frame:
    0.223, 0.207, each under its floor."""
    _hold_frame_to_jax(scene, MARCH_FIVE, FIVE_FLOORS[scene])


def test_mesh_at_options_matches_renderer(mesh_atlases):  # noqa: F811
    """A (4, 1) mesh at lazy_march=False and bilinear_tracking=True bit-equal
    to the Renderer over a spp at 16x8, and the Renderer's interruptible spp
    bit-equal to a whole one; the frame differs from the default config's."""
    options = dict(lazy_march=False, bilinear_tracking=True)
    r, s = _mesh(mesh_atlases, 4, res=(16, 8), options=options), _single(
        mesh_atlases, (16, 8), options=options)
    r.accumulate()
    s.accumulate()
    assert s.color_buffer.any() and torch.equal(r.color_buffer, s.color_buffer)
    c = _single(mesh_atlases, (16, 8), options=options)
    assert c.accumulate_interruptible(3)
    assert torch.equal(c.color_buffer, s.color_buffer)
    default = _single(mesh_atlases, (16, 8))
    default.accumulate()
    assert not torch.equal(default.color_buffer, s.color_buffer)
