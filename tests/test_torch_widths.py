"""The hero-packet widths other than 1 and 4 (``TraceConfig.hero_lambdas``)
in the PyTorch port, against the JAX package on the CPU:

- the packet's rotations: ``ops/spectral.hero_shifts`` and the rotated
  mids bit for bit against the jitted reference's ``mod(mid + arange(L) /
  L, 1)`` (XLA multiplies by the float32 reciprocal), eager JAX's true
  division within one ulp of the shift (it parts at L = 6, 7 and 12;
  ROADMAP C #6); ``gen_rays_plain`` against the reference's ray generation
  (test_torch_raygen's tolerances) at L = 2, 3, 5, 6, 7, 8, 12 and 16;
- bounce 0 of Apollo at L = 2 and 6 against the eager reference on the same
  lanes (test_torch_bounce's floors), one 48x27 frame at L = 2 against the
  JAX ``Renderer`` (test_torch_render's), and ``frame_end_plain`` at L = 16
  against the reference's ``shade_primary_miss``, ``finalize_radiance`` and
  deposit;
- the twins at L = 2, 3, 6, 8 and 16: ``run_window_plain`` bit-equal to the
  per-bounce sweep, ``ratio_track_rmo_plain``'s packet column by column
  bit-equal to one wavelength at a time, a rendered frame of (n, L) state;
- every entry point at L = 3 and 16: a (4, 1) mesh bit-equal to the
  ``Renderer``, chunks, adaptive passes, checkpoints, ``render_offline``,
  and the viewer at L = 3;
- the routing: a width outside 1 and 4 goes to its width library (the
  bounce entries' floor instance), counted at its width; a failed build or
  launch raises; the width sources stay out of the main library;
- L = 0 raises, and ``naive_tracking`` at L = 2;
- tests/test_hero_packets.py's ``test_rotation_sampler_properties`` at
  L = 4, as the reference runs it, and at L = 2, 3 and 6 (gaps 441 / L).
"""

import ctypes
import functools
import json
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.assets.luts import load_spectral_luts as jax_luts
from digital_earth_tpu.render.params import TraceConfig as JaxConfig
from digital_earth_tpu_torch import convert, kernels
from digital_earth_tpu_torch.app.config_io import apply_config, load_config
from digital_earth_tpu_torch.app.viewer import EarthViewer, render_offline
from digital_earth_tpu_torch.assets import luts as tluts
from digital_earth_tpu_torch.ops import spectral as tsp
from digital_earth_tpu_torch.render import frame_end as fe
from digital_earth_tpu_torch.render import params as tparams
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render import raygen, tracers
from digital_earth_tpu_torch.render.params import TraceConfig
from digital_earth_tpu_torch.render.renderer import Renderer
from test_torch_adaptive import _close, _jax_frame_end
from test_torch_adaptive import atlases as end_atlases  # noqa: F401  (fixture)
from test_torch_bounce import _bounce_vs_eager, _hold_to_floors, raw_atlas  # noqa: F401
from test_torch_mesh import _mesh, _single
from test_torch_mesh import atlases as mesh_atlases  # noqa: F401  (fixture)
from test_torch_raygen import KEY, _jax_rays
from test_torch_render import ROOT, default_atlases  # noqa: F401  (fixture)
from test_torch_viewer import _decode_png, _get, _serve, _stop

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

WIDTHS = (2, 3, 5, 6, 7, 8, 12, 16)
TWIN_WIDTHS = (2, 3, 6, 8, 16)
APOLLO = os.path.join(ROOT, "scenes", "config - Apollo 11.txt")
SMALL = dict(max_bounces=3, land_march_steps=64, max_tracking_steps=256)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# --- the rotations ----------------------------------------------------------------


@pytest.mark.parametrize("L", WIDTHS)
def test_rotation_rounds_as_the_jitted_reference(L):
    """The port's rotations are the jitted reference's bits: the shifts
    ``arange(L) * float32(1 / L)`` and the rotated mids ``mod(mid + shift,
    1)`` on 4096 seeded mids. Eager JAX divides, and parts from them by one
    ulp of the shift at L = 6, 7 and 12 of these widths."""
    mid = np.random.default_rng(L).uniform(0.0, 1.0, 4096).astype(np.float32)
    rot = jax.jit(lambda m: jnp.mod(m[:, None] + jnp.arange(L, dtype=jnp.float32) / L, 1.0))
    shifts = tsp.hero_shifts(L).numpy()
    np.testing.assert_array_equal(_bits(shifts), _bits(rot(np.zeros(1, np.float32))[0]))
    got = torch.remainder(torch.from_numpy(mid)[:, None] + tsp.hero_shifts(L), 1.0)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(rot(mid)))
    ulps = np.abs(_bits(np.asarray(jnp.arange(L, dtype=jnp.float32) / L)) - _bits(shifts))
    assert ulps.max() == (1 if L in (6, 7, 12) else 0), ulps


@pytest.mark.parametrize("L", WIDTHS)
def test_rays_match_reference_at_width(L):
    """``gen_rays_plain`` at L against the reference's ray generation on a
    48x27 frame (stratified, test_torch_raygen's): lane keys bit-equal,
    directions within 1e-6; the hero (member 0) bit-equal to the port's
    single-wavelength rays; the wavelengths within 1e-3 nm of the
    reference's (measured at most 5.5e-4: the port's and the eager
    reference's mid part by a few ulps on 7% of lanes, at L = 1 too) and the
    lambda pdf within rtol 1e-5 / atol 1e-6 on 0.998 of the values (measured
    0.9988-0.9995 over these widths; test_torch_raygen holds L = 1 and 4 to
    0.999: each member lands somewhere on the CIE response, and where that
    is steep the mids' few ulps move the pdf by more than 1e-5)."""
    from digital_earth_tpu.render import camera as jcam

    res, spp = (48, 27), 5
    cam_args = dict(position=(3.6e7, 1.2e7, -4.2e7), look_at=(2.3e7, 8.3e6, -2.6e7),
                    up=(0.26, 0.675, -0.69), fov=0.127, aspect_scale=0.997)
    cam = convert.camera_params_to_torch(jcam.make_camera_params(**cam_args), "cpu")
    n = res[0] * res[1]
    luts = tluts.load_spectral_luts("cpu")
    rays, hero = (raygen.gen_rays_plain(KEY, spp, 0, n, res, (1, res[1]), cam, luts, False,
                                        cfg=TraceConfig(hero_lambdas=width)) for width in (L, 1))
    keys, dirs, wl, pdf = _jax_rays(res, spp, cam_args, jax_luts(), True, L, False)
    np.testing.assert_array_equal(rays.keys.numpy(), keys)
    np.testing.assert_allclose(rays.dirs.numpy(), dirs, atol=1e-6)
    assert rays.wavelengths.shape == rays.pdf.shape == (n, L)
    assert rays.responses.shape == (n, L, 3)
    for got, one in ((rays.wavelengths, hero.wavelengths), (rays.responses, hero.responses),
                     (rays.pdf, hero.pdf)):
        assert torch.equal(got[:, :1], one)
    np.testing.assert_allclose(rays.wavelengths.numpy(), wl, rtol=0, atol=1e-3)
    assert np.isclose(rays.pdf.numpy(), pdf, rtol=1e-5, atol=1e-6).mean() >= 0.998
    # the companions sit 441 / L nm apart around the spectrum
    gaps = np.diff(np.sort(rays.wavelengths.numpy(), axis=1), axis=1)
    np.testing.assert_allclose(gaps, 441.0 / L, atol=0.5)


# --- bounce, frame and frame end against the reference -------------------------------

# (radiance, throughput) floors of the share of Apollo's bounce-0 lanes within
# rtol 1e-3 of the eager reference (test_torch_bounce's for Apollo); measured
# L = 2: 0.965, 0.970; L = 6: 0.960, 0.965 (L = 4: 0.962, 0.967)
BOUNCE_FLOORS = {2: (0.95, 0.95), 6: (0.95, 0.95)}


@pytest.mark.parametrize("L", sorted(BOUNCE_FLOORS))
def test_bounce_at_width_matches_eager_reference(raw_atlas, L, monkeypatch):  # noqa: F811
    captured, st = _bounce_vs_eager(raw_atlas, "config - Apollo 11.txt", monkeypatch,
                                    {"hero_lambdas": L})
    assert captured["out"][0].shape[1] == L
    _hold_to_floors(captured, st, BOUNCE_FLOORS[L])


def test_frame_at_width_matches_jax_renderer(default_atlases):  # noqa: F811
    """One 48x27 Apollo spp at L = 2 against the JAX renderer on the same
    atlas (the default TraceConfig otherwise): share of pixels within rtol
    1e-3 (measured 0.973; floor 0.95, test_torch_render's for Apollo at
    L = 4) and the channel means within 5% (measured 0.16%)."""
    from digital_earth_tpu.app.config_io import apply_config as japply
    from digital_earth_tpu.render.renderer import Renderer as JaxRenderer

    jatlas, tatlas = default_atlases
    cfg = load_config(APOLLO)
    ref = JaxRenderer(image_res=(48, 27), atlas=jatlas, tile_pixels=1296,
                      cfg=JaxConfig(hero_lambdas=2))
    japply(ref, cfg)
    ref.accumulate()
    want = np.asarray(ref.color_buffer)
    got = render_offline(cfg, "cpu", spp=1, image_res=(48, 27), out_path=None, atlas=tatlas,
                         cfg=TraceConfig(hero_lambdas=2)).color_buffer.numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= 0.95, share
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.05)


def test_frame_end_plain_at_16_matches_jax(end_atlases):  # noqa: F811
    """``frame_end_plain`` on a seeded end-of-sweep state of 4096 lanes of
    16 wavelengths (test_torch_adaptive's recipe: 40% primary misses, a
    tenth of them in the sun disk, NaN, infinite and negative radiance)
    against the reference's shade_primary_miss -> finalize_radiance -> XYZ
    -> deposit, at test_torch_adaptive's tolerances."""
    from digital_earth_tpu.render import params as jparams

    r = np.random.default_rng(16)
    n, L, w, h = 4096, 16, 96, 64
    cfg = load_config(APOLLO)
    jscene = jparams.make_scene_params(cfg.sun_angle, cfg.sun_path_rot, 7800.0)
    tscene = tparams.make_scene_params("cpu", cfg.sun_angle, cfg.sun_path_rot, 7800.0)
    light = np.asarray(jscene.light_direction)
    d = r.normal(size=(n, 3))
    sun = r.random(n) < 0.1
    d[sun] = light + r.normal(scale=2e-3, size=(sun.sum(), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rad = np.exp(r.normal(-2.0, 2.0, (n, L)))
    rad[r.random((n, L)) < 0.02] = np.nan
    rad[r.random((n, L)) < 0.01] = np.inf
    rad[r.random((n, L)) < 0.02] *= -1.0
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    miss = r.random(n) < 0.4
    state = dict(
        direction=f32(d), wavelength=f32(r.uniform(390.0, 831.0, (n, L))),
        lambda_pdf=f32(r.uniform(0.0, 0.01, (n, L))), throughput=f32(r.uniform(0.0, 1.5, (n, L))),
        radiance=f32(rad), w_mis=f32(r.uniform(0.5, 2.0, (n, L))), primary_miss=miss,
    )
    es = dict(state=state, responses=f32(r.uniform(0.0, 2.0, (n, L, 3))),
              pid=r.permutation(w * h)[:n], res=(w, h), scenes=(jscene, tscene))
    st = pt.TraceState(pos=torch.zeros((n, 3)), alive=torch.zeros(n, dtype=torch.bool),
                       rng=torch.zeros((n, 2), dtype=torch.int64),
                       work_class=torch.zeros(n, dtype=torch.int32),
                       **{k: torch.from_numpy(v) for k, v in state.items()})
    shading = fe.MissShading(st, tscene, end_atlases[1], tluts.load_spectral_luts("cpu"),
                             TraceConfig(hero_lambdas=L))
    color, count, lum2 = torch.zeros((w * h, 3)), torch.zeros(w * h), torch.zeros(w * h)
    fe.frame_end_plain(torch.from_numpy(es["responses"]), torch.from_numpy(es["pid"]), color,
                       count, lum2, miss=shading)
    want_c, want_n, want_l2 = _jax_frame_end(es, end_atlases)
    assert int((miss & sun).sum()) > 50 and np.isfinite(color.numpy()).all()
    _close(color.view(w, h, 3).numpy(), want_c)
    np.testing.assert_array_equal(count.view(w, h).numpy(), want_n)
    _close(lum2.view(w, h).numpy(), want_l2)


# --- the twins at L ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _atlas():
    from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
    from digital_earth_tpu_torch.assets.textures import build_atlas

    return build_atlas(generate_earth_textures((64, 128), seed=3), "cpu")


def _frame_state(L, res=(16, 9)):
    """The bounce-0 state of an Apollo frame at L (64x128 atlas of seed 3)
    and the sweep's arguments."""
    cfg = TraceConfig(hero_lambdas=L, **SMALL)
    r = Renderer("cpu", image_res=res, atlas=_atlas(), cfg=cfg)
    apply_config(r, load_config(APOLLO))
    n = res[0] * res[1]
    rays = raygen.gen_rays_plain(KEY, 0, 0, n, res, (1, res[1]), r.camera_params(), r.luts,
                                 False, cfg=cfg)
    pos = torch.tensor(r.host_camera().position, dtype=torch.float32).expand(n, 3).contiguous()
    st = pt.init_state(pos, rays.dirs, rays.wavelengths, rays.pdf, rays.keys)
    return st, (r.scene_params(), r.atlas, r.luts, cfg)


def _clone(st):
    return pt.TraceState(**{k: v.clone() for k, v in vars(st).items()})


@pytest.mark.parametrize("L", TWIN_WIDTHS)
def test_twins_at_width(L):
    """At L: the window's twin over every bounce bit-equal to the per-bounce
    sweep, the state (n, L) throughout, the frame's end finite."""
    st, args = _frame_state(L)
    cfg = args[3]
    a = pt.run_bounces(_clone(st), *args, 0, cfg.max_bounces)
    b = pt.run_window_plain(_clone(st), torch.arange(st.alive.numel(), dtype=torch.int32), 0,
                            cfg.max_bounces, *args)
    for name, t in vars(a).items():
        assert torch.equal(t, getattr(b, name)), name
    assert a.radiance.shape == a.throughput.shape == a.w_mis.shape == (st.alive.numel(), L)
    assert a.radiance.abs().sum() > 0
    rad = pt.finalize_radiance(pt.shade_primary_miss(a, *args))
    assert torch.isfinite(rad).all() and rad.shape[1] == L


@pytest.mark.parametrize("L", TWIN_WIDTHS)
def test_ratio_tracker_twin_at_width(L):
    """``ratio_track_rmo_plain``'s packet of L wavelengths is one free-flight
    stream at the packet majorant, stopped once every member is below 1e-5:
    each member bit-equal to tracking that wavelength alone at the same
    majorant on every lane where the member alone ends at or above 1e-5, and
    the packet's iterations the most of its members' alone."""
    g = np.random.default_rng(L)
    n = 512
    pos = g.normal(size=(n, 3)) * 1e6
    pos += np.array([0.0, 6.38e6, 0.0])
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ext = g.uniform(1e-7, 4e-5, (n, L, 3)).astype(np.float32)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    keys = torch.from_numpy(g.integers(0, 2**32, (n, 2)))
    span = (f32(pos), f32(d), f32(np.zeros(n)), f32(g.uniform(1e4, 4e5, n)))
    max_ext = f32(ext.sum(-1).max(-1) * 1.5)
    active = torch.from_numpy(g.random(n) < 0.9)
    cfg = TraceConfig(hero_lambdas=L, max_tracking_steps=256)

    def track(e):
        trips = torch.zeros(n, dtype=torch.int32)
        out = tracers.ratio_track_rmo_plain(keys, *span, e, max_ext, active, cfg, trips=trips)
        return out, trips

    packet, trips = track(f32(ext))
    assert packet.shape == (n, L) and int(trips.sum()) > n
    alone = [track(f32(ext[:, j:j + 1])) for j in range(L)]
    for j, (col, _) in enumerate(alone):
        kept = col[:, 0] >= 1e-5
        assert torch.equal(packet[kept, j], col[kept, 0]), j
    assert torch.equal(trips, torch.stack([t for _, t in alone]).amax(0))


# --- every entry point -------------------------------------------------------------


@pytest.mark.parametrize("L", [3, 16])
def test_entry_points_render_at_width(mesh_atlases, L, tmp_path):  # noqa: F811
    """At L: a (4, 1) mesh bit-equal to the Renderer over a spp at 16x8, the
    interruptible spp bit-equal to a whole one, adaptive passes adding whole
    tiles, a checkpoint that resumes bit for bit, ``render_offline``; the
    frame differs from the default width's."""
    options = dict(hero_lambdas=L)
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
    a = _single(mesh_atlases, (16, 8), tile_pixels=8, options=options)
    for _ in range(3):
        assert a.accumulate_adaptive(frac=0.5)
    assert a.mean_spp == pytest.approx(2.5)
    path = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(path)
    b = _single(mesh_atlases, (16, 8), tile_pixels=8, options=options)
    b.load_checkpoint(path)
    a.accumulate_adaptive(frac=0.5)
    b.accumulate_adaptive(frac=0.5)
    assert torch.equal(a.color_buffer, b.color_buffer)
    assert torch.equal(a.count_buffer, b.count_buffer)
    img = render_offline(load_config(APOLLO), "cpu", spp=1, image_res=(16, 9), out_path=None,
                         atlas=mesh_atlases[1], cfg=TraceConfig(**options, **SMALL))
    assert torch.isfinite(img.fetch_image()).all()


def test_viewer_at_width(mesh_atlases, tmp_path):  # noqa: F811
    """The viewer over a port Renderer at L = 3: a preview frame, then path
    spp in chunks, and a PNG of the full size."""
    config = tmp_path / "config.txt"
    config.write_text(open(APOLLO).read())
    r = Renderer("cpu", image_res=(16, 9), atlas=mesh_atlases[1],
                 cfg=TraceConfig(hero_lambdas=3, **SMALL))
    v = EarthViewer(renderer=r, config_path=str(config), screenshot_dir=str(tmp_path / "shots"),
                    port=0, spp_chunks=2)
    loop, server = _serve(v)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            s = json.loads(_get(v, "/state"))
            if s["frame_source"] == "path" and s["spp"] >= 1:
                break
            time.sleep(0.05)
        assert s["error"] is None and s["frame_source"] == "path" and s["spp"] >= 1, s
        assert _decode_png(_get(v, "/frame.png"))[:2] == (16, 9)
    finally:
        _stop(v, loop, server)


# --- the routing to the width libraries ----------------------------------------------


class _StubLib:
    """A library whose C entries record their names (and a bounce entry's
    int block, read during the call) and return ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        if not name.startswith("de_"):
            raise AttributeError(name)

        def entry(*args):
            ints = None
            if name.startswith("de_bounce"):
                ints = list((ctypes.c_int * (kernels.BOUNCE_INTS + 1)).from_address(args[1].value))
            self.calls.append((name, ints))
            return self.rc

        return entry


@pytest.fixture()
def stubs(monkeypatch):
    """The main library and each width library replaced by stubs (and the
    current stream by stream 0)."""
    libs = {"main": _StubLib()}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kernels, "library", lambda: libs["main"])
    monkeypatch.setattr(kernels, "width_library",
                        lambda L: libs.setdefault(L, _StubLib()))
    kernels.reset_launch_counts()
    yield libs
    kernels.reset_launch_counts()


def _bounce_call(L, **cfg_kw):
    """A bounce launch's arguments (CPU tensors) at L and ``cfg_kw``."""
    st, (scene, atlas, luts, cfg) = _frame_state(L, res=(4, 2))
    cfg = TraceConfig(hero_lambdas=L, **SMALL, **cfg_kw)
    frame = pt.BounceFrame(st, scene, atlas, luts, cfg)
    idx = torch.arange(st.alive.numel(), dtype=torch.int32)
    return pt._kernel_args(st, idx, 0, scene, atlas, luts, cfg, frame)


# A width library's two bounce instance sets: the TraceConfig of each case
# and the instance its launches ask for (one knob of each set: a scene
# option, an estimator option, a march floor)
WIDTH_KNOBS = {
    "defaults": ({}, kernels.INST_DEFAULT),
    "scene option": (dict(enable_clouds=False), kernels.INST_FLOORS),
    "estimator option": (dict(fast_loop_rng=True), kernels.INST_FLOORS),
    "march floor": (dict(march_floor_frac_secondary=0.01), kernels.INST_FLOORS),
}


@pytest.mark.parametrize("knob", list(WIDTH_KNOBS))
@pytest.mark.parametrize("L", [2, 6, 16])
def test_width_launches_go_to_their_library(stubs, L, knob):
    """gen_rays and the bounce entries at L go to L's library, the bounce's
    int block asking for the default instance at the defaults and for the
    floor instance at a scene option, an estimator option or a march floor
    (counted as an options launch there), each launch counted at its width;
    frame_end goes to L's library past 8 wavelengths only."""
    cfg_kw, inst = WIDTH_KNOBS[knob]
    g, _ = tluts.ray_tables(tluts.load_spectral_luts("cpu"))
    ip = [0, 0, 0, 0, 0, 4, 2, 1, 2, g.shape[0], L, 0, 1]
    kernels.gen_rays([0.0] * 19, ip, g, tluts.load_spectral_luts("cpu").cie_response, 8, L)
    args = _bounce_call(L, **cfg_kw)
    kernels.bounce_shade(*args, flight=kernels.bounce_flight(*args))
    kernels.bounce_window(*args, stop=2)
    assert kernels.bounce_window.options_launches == int(inst == kernels.INST_FLOORS)
    for name, ints in stubs[L].calls[-3:]:
        assert ints[0] == L and ints[-1] == inst, name
    fp, _ = fe.kernel_params(L)
    kernels.frame_end(fp, [L, 1, 1, 0, 0], torch.zeros((8, L)), torch.zeros((8, L, 3)),
                      torch.arange(8), torch.zeros((8, 3)), miss=_miss_inputs(L))
    names = [name for name, _ in stubs[L].calls]
    assert names == ["de_gen_rays", "de_bounce_flight", "de_bounce_shade", "de_bounce_window"] + (
        ["de_frame_end"] if L > 8 else [])
    assert [name for name, _ in stubs["main"].calls] == ([] if L > 8 else ["de_frame_end"])
    counts = kernels.launch_counts()
    assert counts["gen_rays"] == counts[f"gen_rays/L{L}"] == 1
    assert counts["bounce_flight"] == counts[f"bounce_flight/L{L}"] == 1
    assert counts["frame_end"] == counts[f"frame_end/L{L}"] == 1
    assert not any(k.endswith(("/L1", "/L4")) for k in counts)


@pytest.mark.parametrize("options, inst", [(kernels.INST_DEFAULT, kernels.INST_DEFAULT),
                                           (kernels.INST_FLOORS, kernels.INST_FLOORS),
                                           (True, kernels.INST_FLOORS),
                                           (kernels.INST_ESTIMATOR, kernels.INST_FLOORS)])
def test_width_occupancy_asks_for_its_instance(stubs, options, inst):
    """bounce_occupancy at a width asks L's library for the default instance
    or, for any other, the floor instance (the two sets a width library
    holds); without a width the main library for the instance asked."""
    calls = []

    def occupancy(which, opts, out):
        calls.append((which, opts))
        return 0

    for lib in ("main", 6):
        stubs.setdefault(lib, _StubLib()).de_bounce_occupancy = occupancy
    for which in kernels.OCCUPANCY_ENTRIES:
        kernels.bounce_occupancy(which, options, width=6)
    assert calls == [(i, inst) for i in range(len(kernels.OCCUPANCY_ENTRIES))]
    calls.clear()
    kernels.bounce_occupancy("bounce_shade", options)
    assert calls == [(1, int(options))]


def _miss_inputs(L, n=8):
    f = torch.zeros
    return (f((n, L)), f((n, L)), f((n, L)), f((n, L)), f((n, 3)), f(n, dtype=torch.bool),
            f(3), f(()), torch.zeros((1, 1, 3), dtype=torch.uint8), f((300, 3)))


def test_width_library_failures_raise(stubs, monkeypatch):
    """A launch the width library refuses raises, naming the library, and a
    width library that fails to build raises: nothing falls back to the
    twin."""
    stubs[6] = _StubLib(rc=1)
    g, _ = tluts.ray_tables(tluts.load_spectral_luts("cpu"))
    ip = [0, 0, 0, 0, 0, 4, 2, 1, 2, g.shape[0], 6, 0, 1]
    with pytest.raises(RuntimeError, match="L = 6 library"):
        kernels.gen_rays([0.0] * 19, ip, g, tluts.load_spectral_luts("cpu").cie_response, 8, 6)
    monkeypatch.undo()

    def broken(builds):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(kernels, "_nvcc", broken)
    monkeypatch.setattr(kernels, "_width_libs", {})
    monkeypatch.setattr(kernels.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.width_library(6)
    assert 6 not in kernels._width_libs


def test_width_sources_stay_out_of_the_main_library():
    """The main library builds every .cu of csrc/ and no width source; a
    width library the entries' sources with its define and the default and
    floor instances of csrc/width/ (frame_end past 8 wavelengths), under a
    hash of its own per width; the main and width widths do not overlap."""
    main = kernels._sources()
    assert not any(os.sep + "width" + os.sep in p for p in main)
    for L in (2, 16):
        srcs = [os.path.relpath(p, kernels.CSRC) for p in kernels._width_sources(L)]
        assert srcs == ["bounce.cu", "gen_rays.cu", "rmo_ratio_track.cu"] + (
            ["frame_end.cu"] if L > 8 else []) + [
                "width/bounce_default.cu", "width/bounce_floor.cu",
                "width/bounce_ratio_default.cu", "width/bounce_ratio_floor.cu"]
    dirs = {kernels._library_dir(f"-DDE_WIDTH={L}") for L in (2, 6, 16)} | {
        kernels._library_dir()}
    assert len(dirs) == 4
    with pytest.raises(ValueError):
        kernels.build_width_libraries([4])


# --- refusals ---------------------------------------------------------------------


def test_refuses_no_wavelength_and_naive_packets():
    for bad in (0, -3):
        with pytest.raises(ValueError, match="at least one wavelength"):
            TraceConfig(hero_lambdas=bad)
    with pytest.raises(ValueError, match="single-wavelength"):
        TraceConfig(naive_tracking=True, hero_lambdas=2)
    with pytest.raises(ValueError, match="single-wavelength"):
        convert.trace_config(JaxConfig(naive_tracking=True, hero_lambdas=2))
    for L in (2, 3, 6, 8, 16):
        assert convert.trace_config(JaxConfig(hero_lambdas=L)) == TraceConfig(hero_lambdas=L)
    g, _ = tluts.ray_tables(tluts.load_spectral_luts("cpu"))
    ip = [0, 0, 0, 0, 0, 4, 2, 1, 2, g.shape[0], 0, 0, 1]
    with pytest.raises(ValueError, match="wavelengths"):
        kernels.gen_rays([0.0] * 19, ip, g, tluts.load_spectral_luts("cpu").cie_response, 8, 0)
    z = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="L >= 1"):
        kernels.rmo_ratio_track(torch.zeros((4, 2), dtype=torch.int64), z, z, z[:, 0], z[:, 0],
                                torch.zeros((4, 0, 3)), z[:, 0], torch.ones(4, dtype=torch.bool),
                                max_steps=8, k=4)


# --- tests/test_hero_packets.py ------------------------------------------------------


@pytest.mark.parametrize("L", [4, 2, 3, 6])
def test_rotation_sampler_properties(L):
    """The reference's test at L = 4, and at L = 2, 3 and 6: shapes, the
    visible range, the members spaced by 441 / L nm."""
    luts = tluts.load_spectral_luts("cpu")
    u = torch.from_numpy(np.random.default_rng(0).uniform(0.0, 1.0, 512).astype(np.float32))
    wl, resp, pdf = tsp.spectrum_sample_hero(u, luts.cie_cdf, luts.cie_response, L)
    assert wl.shape == pdf.shape == (512, L) and resp.shape == (512, L, 3)
    wl = wl.numpy()
    assert wl.min() >= 390.0 and wl.max() <= 831.0
    np.testing.assert_allclose(np.diff(np.sort(wl, axis=1), axis=1), 441.0 / L, atol=0.5)
