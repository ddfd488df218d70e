"""Element-wise modules of the PyTorch port against their JAX originals on
the same numpy-seeded inputs (ops/, models/, render/camera.py,
render/params.py, assets/).

Tolerances: JAX's CPU backend contracts multiply-adds into FMAs and uses
its own exp/log/sin/atan2, so results differ from the port by a few ulp;
each tolerance below is about 4x the largest difference measured over the
test's inputs. Chains through a cancellation (the Draine inverse CDF, the
hero-packet CIE lerp, the GGX specular) get the loosest ones."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu import constants as C
from digital_earth_tpu.assets import luts as jluts
from digital_earth_tpu.assets.procgen import generate_earth_textures
from digital_earth_tpu.assets.textures import build_atlas as jax_build_atlas
from digital_earth_tpu.models import atmosphere_lut as jatm
from digital_earth_tpu.models import surface as jsu
from digital_earth_tpu.models import volume as jv
from digital_earth_tpu.ops import math_utils as jm
from digital_earth_tpu.ops import sampling as js
from digital_earth_tpu.ops import spectral as jsp
from digital_earth_tpu.ops import texture as jtx
from digital_earth_tpu.render import camera as jcam
from digital_earth_tpu.render import params as jparams
from digital_earth_tpu_torch import convert
from digital_earth_tpu_torch.assets import luts as tluts
from digital_earth_tpu_torch.assets import textures as ttex
from digital_earth_tpu_torch.models import atmosphere_lut as tatm
from digital_earth_tpu_torch.models import surface as tsu
from digital_earth_tpu_torch.models import volume as tv
from digital_earth_tpu_torch.ops import math_utils as tm
from digital_earth_tpu_torch.ops import sampling as ts
from digital_earth_tpu_torch.ops import spectral as tsp
from digital_earth_tpu_torch.ops import texture as ttx
from digital_earth_tpu_torch.render import camera as tcam
from digital_earth_tpu_torch.render import params as tparams

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8192
R = np.random.default_rng(1234)


def _u(*shape):
    return R.random(shape).astype(np.float32)


def _unit(n):
    v = R.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=1e-6, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def mostly_close(got, want, rtol, atol, share):
    """At least ``share`` of the elements within tolerance: for functions
    whose output jumps where an input crosses a knot (a CDF bracket, the
    perigee sign change of a density integral) by one ulp."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ok = np.isclose(got, np.asarray(want), rtol=rtol, atol=atol)
    assert ok.mean() >= share, ok.mean()


U0, U1, U2 = _u(N), _u(N), _u(N)
V, NRM, LDIR = _unit(N), _unit(N), _unit(N)
WL = (390.0 + 441.0 * _u(N)).astype(np.float32)


@pytest.fixture(scope="module")
def luts():
    return jluts.load_spectral_luts(), tluts.load_spectral_luts("cpu")


# --- ops/math_utils ---------------------------------------------------------


def test_math_utils():
    pos = (_unit(N) * R.uniform(6.0e6, 4.0e7, (N, 1))).astype(np.float32)
    for r in (C.PLANET_R, C.ATMOS_UPPER_LIMIT):
        for got, want in zip(tm.rsi(T(pos), T(V), r), jm.rsi(J(pos), J(V), r)):
            close(got, want, rtol=1e-4, atol=16.0)
    # the NaN fix: misses are exactly -1, never NaN
    near, far = tm.rsi(T(pos), T(V), 1.0)
    assert torch.isfinite(near).all() and torch.isfinite(far).all()
    close(tm.normalize(T(pos)), jm.normalize(J(pos)), atol=1e-7)
    close(tm.cross(T(V), T(NRM)), jm.cross(J(V), J(NRM)), atol=1e-7)
    u, v = tm.sphere_uv_map(T(V))
    ju, jv_ = jm.sphere_uv_map(J(V))
    close(u, ju, atol=1e-6)
    close(v, jv_, atol=1e-6)
    for a, b in zip(tm.make_orthonormal_basis(T(NRM)), jm.make_orthonormal_basis(J(NRM))):
        close(a, b, atol=1e-6)
    x = (4.0 * _u(N) - 2.0).astype(np.float32)
    close(tm.smoothstep(0.3, 0.7, T(x)), jm.smoothstep(0.3, 0.7, J(x)), atol=1e-7)
    close(tm.mix(T(x), T(U0), T(U1)), jm.mix(J(x), J(U0), J(U1)), atol=1e-7)


# --- ops/sampling ------------------------------------------------------------


def test_sampling():
    close(ts.sample_cone_oriented(T(U0), T(U1), 0.99, T(NRM)),
          js.sample_cone_oriented(J(U0), J(U1), 0.99, J(NRM)), atol=3e-7)
    close(ts.sample_hemisphere_cosine_weighted(T(U0), T(U1), T(NRM)),
          js.sample_hemisphere_cosine_weighted(J(U0), J(U1), J(NRM)), atol=2e-6)
    close(ts.sample_sphere(T(U0), T(U1)), js.sample_sphere(J(U0), J(U1)), atol=5e-7)


# --- ops/spectral ------------------------------------------------------------


def test_spectral(luts):
    jl, tl = luts
    close(tsp.plancks(C.SUN_TEMPERATURE, T(WL)), jsp.plancks(C.SUN_TEMPERATURE, J(WL)), rtol=1e-6)
    for got, want in zip(
        tsp.spectrum_sample_hero(T(U0), tl.cie_cdf, tl.cie_response, 4),
        jsp.spectrum_sample_hero(J(U0), jl.cie_cdf, jl.cie_response, 4),
    ):
        mostly_close(got, want, rtol=1e-5, atol=1e-6, share=0.999)
    rgb = _u(N, 3)
    close(tsp.srgb_to_spectrum(tl.srgb2spec, T(rgb), T(WL)),
          jsp.srgb_to_spectrum(jl.srgb2spec, J(rgb), J(WL)), atol=5e-7)
    # int32 truncation toward zero and the out-of-range zero, kept verbatim
    edge = np.array([399.5, 400.0, 400.7, 401.0, 698.9, 699.0, 699.5, 831.0], np.float32)
    close(tsp.srgb_to_spectrum(tl.srgb2spec, T(rgb[:8]), T(edge)),
          jsp.srgb_to_spectrum(jl.srgb2spec, J(rgb[:8]), J(edge)), atol=5e-7)
    close(tsp.srgb_transfer(T(rgb)), jsp.srgb_transfer(J(rgb)), atol=5e-7)
    close(tsp.xyz_to_rgb(T(rgb)), jsp.xyz_to_rgb(J(rgb)), atol=2e-6)
    close(tsp.lum3(T(rgb)), jsp.lum3(J(rgb)), atol=5e-7)


# --- ops/texture and assets/textures ----------------------------------------


@pytest.fixture(scope="module")
def atlases():
    raw = generate_earth_textures((64, 128), seed=3)
    return raw, jax_build_atlas(raw), ttex.build_atlas(raw, "cpu")


def test_convert_round_trip(atlases):
    """A JAX atlas converted equals the port's own atlas builder."""
    raw, jatlas, tatlas = atlases
    conv = convert.atlas_to_torch(jatlas, "cpu")
    for name in ttex.TextureAtlas._fields:
        got, want = getattr(conv, name), getattr(tatlas, name)
        assert got.dtype == torch.uint8 and got.shape == want.shape
        assert torch.equal(got, want), name
    assert tatlas.stars.shape[-1] == 3  # 42 texels per 128-lane row in the JAX layout


@pytest.mark.parametrize("bilinear", [False, True])
def test_texture_sampling(atlases, bilinear):
    _, jatlas, tatlas = atlases
    pos = (V * 6.4e6).astype(np.float32)
    for name in ("topography", "material", "stars"):
        close(ttx.sample_sphere_texture(getattr(tatlas, name), T(pos), bilinear),
              jtx.sample_sphere_texture(getattr(jatlas, name), J(pos), bilinear=bilinear),
              atol=5e-5)
    close(ttx.sample_dir_texture(tatlas.stars, T(V), bilinear),
          jtx.sample_dir_texture(jatlas.stars, J(V), bilinear), atol=5e-5)


def _edge_points(h, w, device="cpu"):
    """chip_smoke.py's tap_edge_points: the points at which the taps of an
    (h, w) texture are held at their edges, on the CPU and on the card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.tap_edge_points(torch, h, w, device=device)


@pytest.mark.parametrize("bilinear", [False, True])
def test_texture_sampling_at_the_edges(atlases, bilinear):
    """sample_sphere_texture and sample_dir_texture against the JAX
    package's at the taps' edge points (chip_smoke.tap_edge_points: u at
    exactly 0 and 1, the seam, both poles and the clamped rows, zero-length,
    tiny, overflowing, NaN and infinite points) on the 4-, 8- and 3-channel
    textures: the twin the card holds its taps to. Tighter than
    test_texture_sampling's 5e-5: nearest taps equal, bilinear ones within
    2e-6 (the angles' last-bit differences through the lerp: 9.4e-7 at
    most), NaN where the reference is NaN."""
    _, jatlas, tatlas = atlases
    tol = dict(rtol=0.0, atol=2e-6 if bilinear else 0.0)
    for name in ("topography", "material", "stars"):
        tex, jtex = getattr(tatlas, name), getattr(jatlas, name)
        pts = _edge_points(*tex.shape[:2])
        p = pts.numpy()
        close(ttx.sample_sphere_texture(tex, pts, bilinear),
              jtx.sample_sphere_texture(jtex, J(p), bilinear=bilinear), **tol)
        close(ttx.sample_dir_texture(tex, pts, bilinear),
              jtx.sample_dir_texture(jtex, J(p), bilinear), **tol)


def test_luts_match(luts):
    jl, tl = luts
    for f in tluts.SpectralLUTs._fields:
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)))
    jc, tc = jluts.load_crf_pack(), tluts.load_crf_pack("cpu")
    np.testing.assert_array_equal(tc.curves.numpy(), np.asarray(jc.curves))
    assert tc.names == jc.names


# --- models/volume, models/surface ------------------------------------------


@pytest.mark.parametrize("reduce_peak", [False, True])
def test_phase_functions(reduce_peak):
    ids = R.integers(0, 5, N).astype(np.int32)
    close(tv.evaluate_phase(T(V), T(LDIR), T(ids), reduce_peak),
          jv.evaluate_phase(J(V), J(LDIR), J(ids), reduce_peak), rtol=1e-4, atol=4e-4)
    d_t, w_t = tv.sample_phase_dirs(T(U2), T(U0), T(U1), T(V), T(ids), reduce_peak)
    d_j, w_j = jv.sample_phase_dirs(J(U2), J(U0), J(U1), J(V), J(ids), reduce_peak)
    close(d_t, d_j, atol=6e-4)
    close(w_t, w_j, atol=1e-6)
    close(tv.sample_draine_cos(T(U0), tv.CLOUD_G_DRAINE, tv.CLOUD_ALPHA_DRAINE),
          jv.sample_draine_cos(J(U0), jv.CLOUD_G_DRAINE, jv.CLOUD_ALPHA_DRAINE), atol=2e-4)


def test_extinctions_and_densities(luts):
    jl, tl = luts
    close(tv.spectra_extinction_rayleigh(T(WL)), jv.spectra_extinction_rayleigh(J(WL)), rtol=1e-6)
    close(tv.spectra_extinction_mie(T(WL)), jv.spectra_extinction_mie(J(WL)), rtol=1e-6)
    close(tv.spectra_extinction_ozone(T(WL), tl.o3_crossec),
          jv.spectra_extinction_ozone(J(WL), jl.o3_crossec), rtol=1e-6)
    h = R.uniform(-1e3, 120e3, N).astype(np.float32)
    close(tv.get_density(T(h)), jv.get_density(J(h)), rtol=2e-6, atol=1e-7)


def test_surface_brdf():
    oc, ba = _u(N), _u(N)
    got = tsu.earth_brdf_parts(T(oc), T(ba), T(V), T(NRM), T(LDIR))
    want = jsu.earth_brdf_parts(J(oc), J(ba), J(V), J(NRM), J(LDIR))
    for g, w in zip(got, want):
        close(g, w, rtol=1e-4, atol=2e-5)


# --- models/atmosphere_lut ----------------------------------------------------


def test_density_table_equal():
    np.testing.assert_array_equal(tatm._build_table(), jatm._build_table())


def test_envelopes_and_perigee():
    assert tatm._O3_ENV_PEAK == pytest.approx(jatm._O3_ENV_PEAK, rel=1e-6)
    h = R.uniform(-100.0, 110e3, N).astype(np.float32)
    close(tatm.density_envelope(T(h)), jatm.density_envelope(J(h)), rtol=2e-6, atol=1e-7)
    rp = R.uniform(6.2e6, 6.5e6, N).astype(np.float32)
    x0 = R.uniform(-3e6, 3e6, N).astype(np.float32)
    x1 = (x0 + R.uniform(0, 3e6, N)).astype(np.float32)
    close(tatm.segment_min_radius(T(rp), T(x0), T(x1)),
          jatm.segment_min_radius(J(rp), J(x0), J(x1)), rtol=1e-6)


def test_density_integrals():
    pos = (_unit(N) * (C.PLANET_R + R.uniform(0, 20e3, (N, 1)))).astype(np.float32)
    d = _unit(N)
    d = np.where((d * pos).sum(1, keepdims=True) < 0, -d, d).astype(np.float32)
    mostly_close(tatm.density_integral_to_space(T(pos), T(d)),
                 jatm.density_integral_to_space(J(pos), J(d)),
                 rtol=2e-3, atol=1.0, share=0.999)
    t1 = R.uniform(0, 3e5, N).astype(np.float32)
    mostly_close(tatm.density_integral_segment(T(pos), T(d), torch.zeros(N), T(t1)),
                 jatm.density_integral_segment(J(pos), J(d), jnp.zeros(N), J(t1)),
                 rtol=2e-3, atol=1.0, share=0.999)
    ext = R.uniform(0, 3e-5, (N, 4, 3)).astype(np.float32)
    mostly_close(tatm.rmo_transmittance_to_space(T(ext), T(pos), T(d)),
                 jatm.rmo_transmittance_to_space(J(ext), J(pos), J(d)),
                 rtol=2e-4, atol=1e-6, share=0.999)


def test_density_check_cpu_path():
    """density_check's CPU path, the twins its kernel is held to on the card,
    against the JAX lookups on seeded lanes (test_density_integrals's
    tolerances)."""
    r = np.random.default_rng(77)
    n = 4096
    v = r.normal(size=(n, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True)
           * (C.PLANET_R + r.uniform(0, 60e3, (n, 1)))).astype(np.float32)
    v = r.normal(size=(n, 3))
    d = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    t0 = r.uniform(0, 1e5, n).astype(np.float32)
    t1 = (t0 + r.uniform(0, 3e5, n)).astype(np.float32)
    ext = r.uniform(0, 3e-5, (n, 4, 3)).astype(np.float32)
    seg, trans = tatm.density_check(T(pos), T(d), T(t0), T(t1), T(ext))
    assert seg.shape == (n, 3) and trans.shape == (n, 4)
    mostly_close(seg, jatm.density_integral_segment(J(pos), J(d), J(t0), J(t1)),
                 rtol=2e-3, atol=1.0, share=0.999)
    mostly_close(trans, jatm.rmo_transmittance_to_space(J(ext), J(pos), J(d)),
                 rtol=2e-4, atol=1e-6, share=0.999)


# --- render/camera, render/params --------------------------------------------


def test_camera_cast_dirs():
    res = (320, 180)
    pu = R.integers(0, 320, N).astype(np.float32)
    pv = R.integers(0, 180, N).astype(np.float32)
    args = dict(position=(3.6e7, 1.2e7, -4.2e7), look_at=(2.3e7, 8.3e6, -2.6e7),
                up=(0.26, 0.675, -0.69), fov=0.127, aspect_scale=0.997)
    jc = jcam.make_camera_params(**args)
    tc = convert.camera_params_to_torch(jc, "cpu")
    close(tcam.cast_dirs(tc, T(pu), T(pv), T(U0), T(U1), res),
          jcam.cast_dirs(jc, J(pu), J(pv), J(U0), J(U1), res), atol=1e-6)


def test_scene_params_and_trace_config():
    js_ = jparams.make_scene_params(5.08, -1.71, 7800.0)
    ts_ = tparams.make_scene_params("cpu", 5.08, -1.71, 7800.0)
    for f in tparams.SCENE_TENSORS:
        close(getattr(ts_, f), getattr(js_, f), atol=1e-7)
    conv = convert.scene_params_to_torch(js_, "cpu")
    for f in tparams.SCENE_TENSORS:
        np.testing.assert_array_equal(getattr(conv, f).numpy(), np.asarray(getattr(js_, f)))
    assert conv.host == tparams.host_scene(*(getattr(conv, f) for f in tparams.SCENE_TENSORS))
    # the port's fields are reference fields with the reference's defaults
    jf = {f.name: f.default for f in jparams.TraceConfig.__dataclass_fields__.values()}
    tf = {f.name: f.default for f in tparams.TraceConfig.__dataclass_fields__.values()}
    assert tf.items() <= jf.items()
    assert convert.trace_config(jparams.TraceConfig()) == tparams.TraceConfig()
    got = convert.trace_config(
        jparams.TraceConfig(max_bounces=3, compact_tile=512, land_march_steps=64))
    assert got == tparams.TraceConfig(max_bounces=3, land_march_steps=64)
    for knob, value in [("loop_narrow", 256), ("scalar_ray_geom", True),
                        ("work_bins", 5), ("loop_narrow_after", 5)]:
        with pytest.raises(ValueError):
            convert.trace_config(jparams.TraceConfig(**{knob: value}))
    # every packet width is carried across (tests/test_torch_widths.py)
    assert convert.trace_config(jparams.TraceConfig(hero_lambdas=2)) == tparams.TraceConfig(
        hero_lambdas=2)
    # the march floors are carried across (tests/test_torch_floors.py)
    for knob, value in [("march_certified_floor", True), ("march_uncert_floor_frac", 0.5),
                        ("march_floor_frac_secondary", 0.002)]:
        got = convert.trace_config(jparams.TraceConfig(**{knob: value}))
        assert getattr(got, knob) == value and got == tparams.TraceConfig(**{knob: value})
    # the estimator options are carried across (tests/test_torch_estimator.py)
    for knob, value in [("fast_loop_rng", True), ("nee_off", True), ("cloud_rr_keep", 0.5),
                        ("flight_newton_iters", 7)]:
        assert getattr(convert.trace_config(jparams.TraceConfig(**{knob: value})), knob) == value


@pytest.mark.parametrize("options", [
    dict(hero_lambdas=1), dict(stratify_spp=False), dict(analytic_transmittance=False),
    dict(hero_lambdas=1, stratify_spp=False, analytic_transmittance=False),
    dict(hero_lambdas=4, stratify_spp=True, analytic_transmittance=True, tracking_k=1),
])
def test_trace_config_carries_the_reference_estimator(options):
    """``convert.trace_config`` carries the reference estimator's three
    options across (alone and together), and the port's TraceConfig refuses
    a packet of no wavelength."""
    got = convert.trace_config(jparams.TraceConfig(**options))
    assert got == tparams.TraceConfig(**options)
    for name, value in options.items():
        assert getattr(got, name) == value
    with pytest.raises(ValueError, match="at least one wavelength"):
        tparams.TraceConfig(hero_lambdas=0)


@pytest.mark.parametrize("option,value", [
    ("enable_clouds", False), ("enable_land", False), ("bilinear_tracking", True),
    ("lazy_march", False), ("march_exact_ocean", False), ("march_ref_phantom", False),
    ("march_stall_patience", 0), ("march_stall_patience", 8),
])
def test_trace_config_carries_the_scene_and_march_options(option, value):
    """``convert.trace_config`` carries each of the reference's seven scene
    and march options across, alone and with the other six at their
    non-default values; the port's defaults are the reference's."""
    assert tparams.SCENE_OPTIONS == {
        name: jparams.TraceConfig.__dataclass_fields__[name].default
        for name in tparams.SCENE_OPTIONS}
    got = convert.trace_config(jparams.TraceConfig(**{option: value}))
    assert getattr(got, option) == value
    assert got == tparams.TraceConfig(**{option: value})
    assert got.options() == {option: value}
    every = {name: not default if isinstance(default, bool) else 0
             for name, default in tparams.SCENE_OPTIONS.items()}
    every[option] = value
    assert convert.trace_config(jparams.TraceConfig(**every)) == tparams.TraceConfig(**every)


def test_angles_are_float32():
    """make_scene_params evaluates its trigonometry in float32 like JAX."""
    s = tparams.make_scene_params("cpu", math.radians(60.0), math.radians(-45.0))
    assert s.light_direction.dtype == torch.float32


# --- remaining math_utils helpers, bounce-level functions, film pieces --------


def test_hashes_and_host_helpers():
    # against the eager reference: the hashes amplify rounding through
    # fract(), and JAX's own eager and jitted results agree on only ~80%
    # (jit contracts the dot into FMAs; eager JAX and the port round op by
    # op, and agree bit for bit)
    p = (R.uniform(-500.0, 500.0, (N, 2))).astype(np.float32)
    np.testing.assert_array_equal(tm.hash12(T(p)).numpy(), np.asarray(jm.hash12(J(p))))
    np.testing.assert_array_equal(tm.hash22(T(p)).numpy(), np.asarray(jm.hash22(J(p))))
    x = _u(N)
    close(tm.normal_distribution(T(x), 0.3, 0.2), jm.normal_distribution(J(x), 0.3, 0.2),
          rtol=1e-6)
    np.testing.assert_array_equal(
        tm.np_rotate_matrix((0.2, 1.0, -0.3), 0.7), jm.np_rotate_matrix((0.2, 1.0, -0.3), 0.7)
    )


def test_bounce_surface_functions(atlases):
    from digital_earth_tpu.render import pathtracer as jpt
    from digital_earth_tpu_torch.render import pathtracer as tpt

    _, jatlas, tatlas = atlases
    pos = (V * (C.PLANET_R + R.uniform(0.0, 8e3, (N, 1)))).astype(np.float32)
    close(tpt.land_normal(tatlas.topography, T(pos), torch.tensor(7800.0)),
          jpt.land_normal(jatlas.topography, J(pos), jnp.float32(7800.0)), atol=2e-3)
    for got, want in zip(tpt.get_land_material(tatlas, T(pos)),
                         jpt.get_land_material(jatlas, J(pos))):
        close(got, want, atol=2e-5)
    land = R.uniform(-1.0, 2e5, N).astype(np.float32)
    for got, want in zip(tpt.intersect_cloud_limits(T(pos), T(NRM), T(land)),
                         jpt.intersect_cloud_limits(J(pos), J(NRM), J(land))):
        mostly_close(got, want, rtol=1e-4, atol=8.0, share=0.999)
    for got, want in zip(tpt._rmo_span(T(pos), T(NRM), T(land)),
                         jpt._rmo_span(J(pos), J(NRM), J(land))):
        mostly_close(got, want, rtol=1e-4, atol=8.0, share=0.999)


def test_spectral_flight_weights(luts):
    from digital_earth_tpu.render import pathtracer as jpt
    from digital_earth_tpu_torch.render import pathtracer as tpt

    jl, tl = luts
    pos = (V * (C.PLANET_R + R.uniform(0.0, 60e3, (N, 1)))).astype(np.float32)
    wl = (390.0 + 441.0 * _u(N, 4)).astype(np.float32)
    ext = np.asarray(jnp.stack([
        jv.spectra_extinction_rayleigh(J(wl)), jv.spectra_extinction_mie(J(wl)),
        jv.spectra_extinction_ozone(J(wl), jl.o3_crossec)], axis=-1))
    t0 = np.zeros(N, np.float32)
    t1 = R.uniform(0.0, 2e5, N).astype(np.float32)
    iid = R.integers(0, 4, N).astype(np.int32)
    coll = R.random(N) < 0.5
    act = R.random(N) < 0.9
    mostly_close(
        tpt.spectral_flight_weights(T(pos), T(LDIR), T(t0), T(t1), T(ext), T(iid), T(coll), T(act)),
        jpt.spectral_flight_weights(J(pos), J(LDIR), J(t0), J(t1), J(ext), J(iid), J(coll), J(act)),
        rtol=1e-3, atol=1e-6, share=0.999,
    )


def test_film_pieces():
    from digital_earth_tpu.render import film as jfilm
    from digital_earth_tpu_torch.render import film as tfilm

    rgb = (R.uniform(0.0, 3.0, (N, 3))).astype(np.float32)
    close(tfilm.opendrt_transform(T(rgb)), jfilm.opendrt_transform(J(rgb)), atol=2e-5)
    curves = tluts.load_crf_pack("cpu").curves
    x = _u(N, 3)
    for idx in (0, 12):
        close(tfilm.camera_response(curves, idx, T(x)),
              jfilm.camera_response(jluts.load_crf_pack().curves, idx, J(x)), atol=2e-6)


# --- the port's copies of the JAX package's numpy-only modules ---------------


def test_constants_copy_equal():
    from digital_earth_tpu_torch import constants as tconst

    names = [n for n in vars(C) if n.isupper()]
    assert names and names == [n for n in vars(tconst) if n.isupper()]
    for n in names:
        np.testing.assert_array_equal(getattr(tconst, n), getattr(C, n), err_msg=n)


def test_procgen_copy_equal():
    from digital_earth_tpu_torch.assets.procgen import generate_earth_textures as tgen

    want = generate_earth_textures((48, 96), seed=11)
    got = tgen((48, 96), seed=11)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("scene", ["config - Apollo 11.txt", "config - florida.txt",
                                   "config - sunset hurricane.txt"])
def test_config_io_copy_equal(scene, tmp_path):
    import dataclasses
    import os

    from digital_earth_tpu.app import config_io as jio
    from digital_earth_tpu_torch.app import config_io as tio

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scenes", scene)
    cfg = tio.load_config(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jio.load_config(path))
    tio.save_config(str(tmp_path / "c.txt"), cfg)
    assert dataclasses.asdict(jio.load_config(str(tmp_path / "c.txt"))) == dataclasses.asdict(cfg)
