"""One bounce of the port's path tracer against the JAX reference on the
same lanes: the port renders the golden configuration of a scene (32x18,
tools/gen_golden.py), its bounce-0 wavefront (positions, directions,
wavelengths, pdfs, lane keys) goes through the reference's ``run_bounces``
run eagerly, and each lane's radiance and throughput are compared.

Why eagerly: the reference does not agree with itself at rtol 1e-3 across
compilations. XLA's CPU backend fuses multiply-adds where its fusion puts
them, so the jitted frame rounds differently from the eager one; at planet
scale a one-ulp position change is 0.5 m, and grazing density integrals
move by 1e-4 to 8e-4 of themselves per metre (the 8 km and 1.2 km scale
heights) before exp(-tau) multiplies it by the optical depth. Measured on
sunset's bounce-0 lanes: JAX eager vs JAX jit 0.877 of lanes within rtol
1e-3, the port vs JAX jit 0.887, the port vs JAX eager 0.988. The frame
goldens (test_torch_render.py) come from the jitted renderer and absorb
that spread; this test holds the port to the eager reference, where a bug
in one lane's arithmetic shows.

Measured shares of lanes within rtol 1e-3 (radiance, throughput): apollo
0.962, 0.967; florida 1.000, 1.000; sunset 0.988, 1.000. Stated floors
below. Apollo's lanes part at the RMO tracker's event distance, where the
reference's compiled bounce body rounds differently from its own
``sample_interaction`` (which the port matches):
``test_apollo_lanes_part_where_jax_rounds_its_own_tracker`` bisects it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.assets.luts import load_spectral_luts as jax_luts
from digital_earth_tpu.assets.procgen import generate_earth_textures
from digital_earth_tpu.assets.textures import build_atlas as jax_build_atlas
from digital_earth_tpu.render import pathtracer as jpt
from digital_earth_tpu.render.params import TraceConfig as JaxConfig
from digital_earth_tpu.render.params import make_scene_params
from digital_earth_tpu_torch.app.config_io import load_config
from digital_earth_tpu_torch.app.viewer import render_offline
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render.params import TraceConfig

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_bounces=1, land_march_steps=64, max_tracking_steps=256)
FLOORS = {  # (radiance, throughput) share of lanes within rtol 1e-3
    "config - Apollo 11.txt": (0.95, 0.95),
    "config - florida.txt": (0.99, 0.99),
    "config - sunset hurricane.txt": (0.98, 0.99),
}


@pytest.fixture(scope="module")
def raw_atlas():
    return generate_earth_textures((64, 128), seed=3)


def _bounce_vs_eager(raw_atlas, scene, monkeypatch, options=None):
    """The port's bounce 0 of ``scene``'s 32x18 frame at ``KW`` and the
    TraceConfig ``options``, and the eager reference's on the same lanes:
    (captured port output, reference state after the bounce)."""
    options = options or {}
    captured = {}
    run_bounces = pt.run_bounces

    def keep(st, scene_params, atlas, luts, cfg, start, stop, interrupt=None):
        if start == 0:
            captured["in"] = {f: getattr(st, f).clone() for f in
                              ("pos", "direction", "wavelength", "lambda_pdf", "rng")}
        out = run_bounces(st, scene_params, atlas, luts, cfg, start, stop, interrupt)
        if start == 0:
            captured["out"] = (out.radiance.clone(), out.throughput.clone())
            captured["class"] = (out.alive.clone(), out.work_class.clone())
        return out

    monkeypatch.setattr(pt, "run_bounces", keep)
    cfg = load_config(os.path.join(ROOT, "scenes", scene))
    render_offline(cfg, "cpu", spp=1, image_res=(32, 18), out_path=None,
                   atlas=build_atlas(raw_atlas, "cpu"), seed=0, cfg=TraceConfig(**KW, **options))

    s = {k: jnp.asarray(v.numpy()) for k, v in captured["in"].items()}
    st = jpt.init_state(s["pos"], s["direction"], s["wavelength"], s["lambda_pdf"],
                        rng_keys=jnp.asarray(captured["in"]["rng"].numpy().astype(np.uint32)))
    scene_params = make_scene_params(cfg.sun_angle, cfg.sun_path_rot)
    st = jpt.run_bounces(st, scene_params, jax_build_atlas(raw_atlas), jax_luts(),
                         JaxConfig(**KW, **options), 0, 1)
    return captured, st


def _hold_to_floors(captured, st, floors):
    for got, want, floor in zip(captured["out"], (st.radiance, st.throughput), floors):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all() and got.shape == want.shape
        share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
        assert share >= floor, share

    # the next bounce's work class: a lane agrees when both keep it alive
    # with the same class or both end it; at least the radiance floor's share
    alive, work_class = (t.numpy() for t in captured["class"])
    same = alive == np.asarray(st.alive)
    agree = same & (~alive | (work_class == np.asarray(st.work_class)))
    assert agree.mean() >= floors[0], agree.mean()
    assert set(np.unique(work_class[alive])) <= {0, 1, 2}


@pytest.mark.parametrize("scene", sorted(FLOORS))
def test_bounce_matches_eager_reference(raw_atlas, scene, monkeypatch):
    _hold_to_floors(*_bounce_vs_eager(raw_atlas, scene, monkeypatch), FLOORS[scene])


# The reference's estimator options, one at a time: (radiance, throughput)
# floors of the share of lanes within rtol 1e-3. Measured: ratio tracking of
# the gases' sun transmittance (analytic_transmittance=False) apollo 0.958,
# 0.967; florida 0.991, 1.000; sunset 0.990, 1.000 (the tracker's event
# chain adds its own rounding to the closed form's); one wavelength a path
# (hero_lambdas=1) apollo 0.971, 1.000.
OPTION_FLOORS = {
    ("config - Apollo 11.txt", "analytic_transmittance", False): (0.95, 0.95),
    ("config - florida.txt", "analytic_transmittance", False): (0.98, 0.99),
    ("config - sunset hurricane.txt", "analytic_transmittance", False): (0.98, 0.99),
    ("config - Apollo 11.txt", "hero_lambdas", 1): (0.96, 0.99),
}


@pytest.mark.parametrize("scene,option,value", sorted(OPTION_FLOORS))
def test_bounce_at_reference_estimator_options_matches_eager_reference(
        raw_atlas, scene, option, value, monkeypatch):
    captured, st = _bounce_vs_eager(raw_atlas, scene, monkeypatch, {option: value})
    assert captured["out"][0].shape[1] == (value if option == "hero_lambdas" else 4)
    _hold_to_floors(captured, st, OPTION_FLOORS[(scene, option, value)])


def test_apollo_lanes_part_where_jax_rounds_its_own_tracker(raw_atlas, monkeypatch):
    """Which stage sets Apollo's lower share above (ROADMAP C #3). Of the
    bounce-0 lanes outside rtol 1e-3, none differs in the march outcome
    (alive, primary miss, next work class) or in the event the flight
    samples; they part at the RMO tracker's event distance. There the port
    agrees (rtol 1e-6) with the reference's own ``sample_interaction``
    called on the same inputs, on every event lane; it is the reference's
    compiled bounce body that rounds the float32 distance (5e7 m from the
    planet's centre, an ulp of 4 m, summed over the tracker's steps)
    differently from that call. Measured: 30 of 576 lanes part; 29 of them
    have an event, and on all 91 event lanes the port's stage is within 1e-6
    of the reference stage's; where a lane scattered, the reference's bounce
    puts it where its own stage does on 10 of the 26 parting lanes and on 55
    of the 59 others. Against a float64 run of the same draws (the port's
    tracker twin in float64), on the 24 parting gas-scatter lanes the port
    sits a median 32 m off and the reference's bounce 92 m, so neither is the
    exact one: JAX rounding, not a port fault."""
    from digital_earth_tpu.models import volume as jvol
    from digital_earth_tpu.ops import math_utils as jmu
    from digital_earth_tpu.ops import rng as jrng
    from digital_earth_tpu_torch import constants as C
    from digital_earth_tpu_torch.models import volume as vol
    from digital_earth_tpu_torch.ops import math_utils as mu
    from digital_earth_tpu_torch.ops import rng

    captured = {}
    run_bounces = pt.run_bounces

    def keep(st, scene_params, atlas, luts, cfg, start, stop, interrupt=None):
        captured["in"] = pt.TraceState(**{f: getattr(st, f).clone() for f in
                                          st.__dataclass_fields__})
        captured["args"] = (atlas, luts, cfg)
        captured["out"] = run_bounces(st, scene_params, atlas, luts, cfg, start, stop, interrupt)
        return captured["out"]

    monkeypatch.setattr(pt, "run_bounces", keep)
    scene = "config - Apollo 11.txt"
    cfg = load_config(os.path.join(ROOT, "scenes", scene))
    render_offline(cfg, "cpu", spp=1, image_res=(32, 18), out_path=None,
                   atlas=build_atlas(raw_atlas, "cpu"), seed=0, cfg=TraceConfig(**KW))
    s, out = captured["in"], captured["out"]
    atlas, luts, tcfg = captured["args"]
    jatlas, jl = jax_build_atlas(raw_atlas), jax_luts()
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    keys = jnp.asarray(s.rng.numpy().astype(np.uint32))
    jst = jpt.init_state(J(s.pos), J(s.direction), J(s.wavelength), J(s.lambda_pdf),
                         rng_keys=keys)
    jout = jpt.run_bounces(jst, make_scene_params(cfg.sun_angle, cfg.sun_path_rot), jatlas, jl,
                           JaxConfig(**KW), 0, 1)

    # the flight stage alone, on both sides, from the same bounce-0 inputs
    n = s.pos.shape[0]
    ext = torch.stack([vol.spectra_extinction_rayleigh(s.wavelength),
                       vol.spectra_extinction_mie(s.wavelength),
                       vol.spectra_extinction_ozone(s.wavelength, luts.o3_crossec)], -1)
    near, _ = mu.rsi(s.pos, s.direction, C.PLANET_R)
    cap = torch.where(near > 0.0, near, -1.0)  # the base sphere, as the bounce's first pass
    keys_f = rng.fold(rng.fold(s.rng, 0), pt._SITE_FLIGHT)
    ev, t, _, _, _ = pt.sample_interaction(
        keys_f, s.pos, s.direction, cap, ext, torch.full((n,), C.CLOUDS_EXTINCT), atlas,
        torch.ones(n, dtype=torch.bool), tcfg)
    jext = jnp.stack([jvol.spectra_extinction_rayleigh(J(s.wavelength)),
                      jvol.spectra_extinction_mie(J(s.wavelength)),
                      jvol.spectra_extinction_ozone(J(s.wavelength), jl.o3_crossec)], -1)
    jnear, _ = jmu.rsi(J(s.pos), J(s.direction), C.PLANET_R)
    ext_w = jnp.full((n,), C.CLOUDS_EXTINCT)
    jev, jt, _, _, _ = jpt.sample_interaction(
        jrng.fold(jrng.fold(keys, 0), jpt._SITE_FLIGHT), J(s.pos), J(s.direction),
        jnp.where(jnear > 0.0, jnear, -1.0), jext, ext_w,
        jnp.max(jnp.sum(jext * jpt._MAX_DENS_RMO, axis=-1), axis=-1), ext_w * C.CLOUDS_DENSITY,
        jatlas, jnp.ones(n, bool), JaxConfig(**KW))
    ev, t, jev, jt = ev.numpy(), t.numpy(), np.asarray(jev), np.asarray(jt)

    ok = lambda a, b: np.isclose(a, b, rtol=1e-3, atol=1e-7).all(-1)  # noqa: E731
    part = ~(ok(out.radiance.numpy(), np.asarray(jout.radiance))
             & ok(out.throughput.numpy(), np.asarray(jout.throughput)))
    alive = out.alive.numpy()
    # the parting lanes by the event their flight sampled (0 none: a surface
    # hit; 1 absorb; 2 scatter), shown on any failure below
    table = dict(parting=int(part.sum()), by_event=np.bincount(ev[part], minlength=3).tolist(),
                 alive=int((part & alive).sum()))
    assert 0 < part.sum() <= 0.06 * n, table
    for name in ("alive", "primary_miss"):
        assert (getattr(out, name).numpy() == np.asarray(getattr(jout, name)))[part].all(), table
    assert (out.work_class.numpy() == np.asarray(jout.work_class))[part & alive].all(), table
    assert np.array_equal(ev, jev), table  # the same event everywhere
    has_event = ev > 0
    assert has_event[part].mean() >= 0.9, table
    same = lambda a, b: np.isclose(a, b, rtol=1e-6, atol=1.0)  # noqa: E731
    assert same(t, jt)[has_event].all()  # the port's stage is the reference's
    # every parting lane that lives on (a scatter or a surface hit) moves
    # elsewhere: none parts at the sun transmittance alone
    moved = (out.pos.numpy() != np.asarray(jout.pos)).any(-1)
    assert moved[part & alive].all(), table
    # where a lane scattered, its new position holds its event distance
    scattered = has_event & alive & (out.work_class.numpy() < 2)
    p0 = s.pos.numpy().astype(np.float64)
    t_port = np.linalg.norm(out.pos.numpy() - p0, axis=-1)
    t_jax = np.linalg.norm(np.asarray(jout.pos, np.float64) - p0, axis=-1)
    assert same(t_port, t)[scattered].all()
    own = same(t_jax, jt)
    assert own[scattered & part].mean() <= 0.5 < own[scattered & ~part].mean()

    # the same draws in float64 (the tracker twin; the cloud pass's cap as is)
    f64 = torch.float64
    pos, d = s.pos.to(f64), s.direction.to(f64)
    c_start, c_max = pt.intersect_cloud_limits(s.pos, s.direction, cap)
    c_ev, c_t = pt.track_cloud(rng.fold(keys_f, pt._SUB_CLOUD), s.pos, s.direction, c_start, c_max,
                               torch.full((n,), C.CLOUDS_EXTINCT), atlas.clouds,
                               torch.ones(n, dtype=torch.bool), tcfg, mode="delta")
    t0, t1 = pt._rmo_span(pos, d, cap.to(f64))
    _, t64, _ = pt.delta_track_rmo(rng.fold(keys_f, pt._SUB_RMO), pos, d, t0,
                                   torch.where(c_ev > 0, torch.minimum(t1, c_t.to(f64)), t1),
                                   ext[:, 0, :].to(f64).contiguous(),
                                   torch.ones(n, dtype=torch.bool), tcfg)
    off = scattered & part & (c_ev.numpy() == 0)
    err_port = np.median(np.abs(t_port - t64.numpy())[off])
    err_jax = np.median(np.abs(t_jax - t64.numpy())[off])
    assert off.sum() >= 20 and min(err_port, err_jax) > 10.0, (err_port, err_jax)
