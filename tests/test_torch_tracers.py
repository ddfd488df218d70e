"""The three per-lane loops of the PyTorch port (render/tracers.py) against
their JAX originals on 4096 lanes with the same per-lane keys:

- land march (intersect_land + phantom crawl): >= 98% hit/miss agreement,
  median relative hit-distance error < 5e-4 (docs/PERFORMANCE.md targets);
- RMO delta tracker and cloud delta tracker: event agreement >= 99%,
  median relative event-distance error < 1e-5 (measured: 0 and 6e-8);
- cloud ratio tracker: mean transmittance within 1e-3.

The kernels themselves are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu import constants as C
from digital_earth_tpu.assets.luts import load_spectral_luts
from digital_earth_tpu.assets.procgen import generate_earth_textures
from digital_earth_tpu.assets.textures import build_atlas
from digital_earth_tpu.models import volume as jvol
from digital_earth_tpu.ops import rng as jrng
from digital_earth_tpu.render import pathtracer as jpt
from digital_earth_tpu.render.params import TraceConfig as JaxConfig
from digital_earth_tpu_torch import convert
from digital_earth_tpu_torch.ops import rng as trng
from digital_earth_tpu_torch.render import tracers
from digital_earth_tpu_torch.render.params import TraceConfig

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

N = 4096
SCALE = 7800.0


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def case():
    """Rays from orbit aimed at the limb and disk, and rays from just above
    the terrain in random directions (the bounce > 0 population)."""
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
    dirs = np.concatenate([d0, unit(N - h)]).astype(np.float32)
    pos = pos.astype(np.float32)
    active = r.random(N) < 0.95
    wl = r.uniform(390.0, 830.0, (N, 4)).astype(np.float32)
    ids = np.arange(N)

    jatlas = build_atlas(generate_earth_textures((128, 256), seed=3))
    luts = load_spectral_luts()
    ext = np.asarray(jnp.stack([
        jvol.spectra_extinction_rayleigh(jnp.asarray(wl)),
        jvol.spectra_extinction_mie(jnp.asarray(wl)),
        jvol.spectra_extinction_ozone(jnp.asarray(wl), luts.o3_crossec),
    ], axis=-1))
    return dict(
        pos=pos, dirs=dirs, active=active, ext=ext,
        jatlas=jatlas, tatlas=convert.atlas_to_torch(jatlas, "cpu"),
        jkeys=jrng.lane_keys(jax.random.PRNGKey(5), jnp.asarray(ids)),
        tkeys=trng.lane_keys(trng.prng_key(5, "cpu"), torch.from_numpy(ids)),
    )


def _march_both(case, any_hit, t_cap):
    j = np.asarray(jpt.intersect_land(
        case["jatlas"].topography, jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]),
        jnp.float32(SCALE), jnp.asarray(case["active"]), JaxConfig(),
        t_cap=None if t_cap is None else jnp.asarray(t_cap), any_hit=any_hit,
    ))
    args = (case["tatlas"].topography, T(case["pos"]), T(case["dirs"]),
            torch.tensor(SCALE), T(case["active"]), TraceConfig())
    kw = dict(t_cap=None if t_cap is None else T(t_cap), any_hit=any_hit)
    return j, args, kw


@pytest.mark.parametrize("any_hit,capped", [(False, False), (True, False), (False, True)])
def test_land_march_matches_jax(case, any_hit, capped):
    t_cap = None
    if capped:
        t_cap = np.random.default_rng(1).uniform(1e3, 3e7, N).astype(np.float32)
    j, args, kw = _march_both(case, any_hit, t_cap)
    t = tracers.intersect_land(*args, **kw).numpy()
    assert 0.2 < (j >= 0).mean() < 0.9  # the case mixes hits and misses
    assert ((j >= 0) == (t >= 0)).mean() >= 0.98
    both = (j >= 0) & (t >= 0)
    assert np.median(np.abs(t[both] - j[both]) / np.maximum(j[both], 1.0)) < 5e-4


@pytest.mark.parametrize("k", [3, 5, 6, 64])
def test_land_march_kernel_refuses_march_k_off_the_warp(k):
    """The land march kernel spreads a lane's march_k probes over march_k
    threads of a warp: its wrapper rejects a march_k that does not divide
    32 before any launch (the plain version takes any march_k)."""
    from digital_earth_tpu_torch import kernels

    n = 4
    topo = torch.zeros((8, 16, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="divide 32"):
        kernels.land_march(topo, torch.zeros((n, 3)), torch.zeros((n, 3)),
                           torch.ones(n, dtype=torch.bool), torch.full((n,), np.inf), 7800.0,
                           step_floor=1.0, stall_thresh=1.0, steps=8, k=k, patience=5,
                           any_hit=False)


def _misaligned_texture(h, w):
    """A contiguous uint8 (h, w, 4) texture whose data starts one byte into
    its buffer: not 4-byte aligned."""
    tex = torch.zeros(h * w * 4 + 1, dtype=torch.uint8)[1:].view(h, w, 4)
    assert tex.is_contiguous() and tex.data_ptr() % 4
    return tex


def _misaligned_material(h, w):
    """A contiguous uint8 (h, w, 8) texture whose data starts four bytes into
    its buffer: 4-byte but not 8-byte aligned."""
    tex = torch.zeros(h * w * 8 + 4, dtype=torch.uint8)[4:].view(h, w, 8)
    assert tex.is_contiguous() and tex.data_ptr() % 8 == 4
    return tex


def _texture_call(wrapper, tex, material=None):
    """A call of ``wrapper`` (kernels' function, "/texture" naming the one
    it gets where it takes two) on CPU tensors of 4 lanes, ``tex`` in place
    of its 4-channel texture (sphere_tap's texture, of any channels), and
    ``material`` in place of its 8-channel one where given."""
    from digital_earth_tpu_torch import kernels

    n, (h, w) = 4, tex.shape[:2]
    z3, z = torch.zeros((n, 3)), torch.zeros(n)
    act = torch.ones(n, dtype=torch.bool)
    good = torch.zeros((h, w, 4), dtype=torch.uint8)
    if material is None:
        material = torch.zeros((h, w, 8), dtype=torch.uint8)
    o3, srgb2spec = torch.zeros(441), torch.zeros((300, 3))
    name, _, which = wrapper.partition("/")
    if name == "cloud_track":
        return lambda: kernels.cloud_track(torch.zeros((n, 2), dtype=torch.int64), z3, z3, z, z,
                                           z, act, tex, max_steps=8, k=4, ratio=False)
    if name == "land_march":
        return lambda: kernels.land_march(tex, z3, z3, act, z, 7800.0, step_floor=1.0,
                                          stall_thresh=1.0, steps=8, k=4, patience=5,
                                          any_hit=False)
    if name == "sphere_tap":
        return lambda: kernels.sphere_tap(tex, z3, False)
    if name == "preview":
        ip = [0, 4, 0, 0, n, h, w, h, w, h, w, 1, 0, 1, 1]
        return lambda: kernels.preview([0.0] * 22, ip, (0, 0), None, z3, z, None, None, tex,
                                       material, torch.zeros((h, w, 3), dtype=torch.uint8), o3,
                                       srgb2spec, origin=(0.0, 0.0, 0.0))
    z4 = torch.zeros((n, 4))
    ip = [4, 0, 0, 8, 4, 2, 8, 4, 0, h, w, h, w, h, w, 0] + [
        kernels.OPTION_DEFAULTS[name] for name in kernels.BOUNCE_OPTIONS] + list(
        kernels.BOUNCE_ESTIMATOR_INTS.values())  # the options' defaults
    fp = [0.0] * 16 + [1.0] * (kernels.BOUNCE_FLOATS - 16)  # the roulettes' defaults
    args = (fp, ip, z3, z3, z4, z4, z4, z4, z4, act, act.clone(),
            torch.zeros(n, dtype=torch.int32), torch.zeros((n, 2), dtype=torch.int32),
            torch.arange(n, dtype=torch.int32), tex if which == "topo" else good, material,
            tex if which == "clouds" else good, o3, srgb2spec, torch.zeros((384, 1024, 3)))
    return {"bounce_flight": lambda: kernels.bounce_flight(*args),
            "bounce_shade": lambda: kernels.bounce_shade(*args, flight=torch.zeros((n, 4))),
            "bounce_window": lambda: kernels.bounce_window(*args, stop=3)}[name]


@pytest.mark.parametrize("wrapper", [
    "cloud_track", "land_march", "sphere_tap", "preview", "bounce_flight/topo",
    "bounce_flight/clouds", "bounce_shade/topo", "bounce_shade/clouds", "bounce_window/topo",
    "bounce_window/clouds",
])
def test_kernel_wrappers_refuse_a_misaligned_4_channel_texture(wrapper):
    """The kernels read a nearest 4-channel texel as one 32-bit word
    (csrc/texture.cuh texel4): every wrapper that passes a 4-channel
    texture to a kernel rejects a contiguous one whose data is not 4-byte
    aligned, before any launch."""
    with pytest.raises(ValueError, match="4-byte aligned"):
        _texture_call(wrapper, _misaligned_texture(8, 16))()


@pytest.mark.parametrize("wrapper", [
    "sphere_tap", "preview", "bounce_flight", "bounce_shade", "bounce_window",
])
def test_kernel_wrappers_refuse_a_misaligned_8_channel_texture(wrapper):
    """The kernels' bilinear taps read an 8-channel texel as one 64-bit word
    (csrc/texture.cuh texel8): every wrapper that passes an 8-channel
    texture (the material) to a kernel rejects a contiguous one whose data
    is 4-byte but not 8-byte aligned, before any launch."""
    material = _misaligned_material(8, 16)
    good = torch.zeros((8, 16, 4), dtype=torch.uint8)
    call = (_texture_call(wrapper, material) if wrapper == "sphere_tap"
            else _texture_call(wrapper, good, material=material))
    with pytest.raises(ValueError, match="8-byte aligned"):
        call()


def test_tap_launchers_refuse_what_they_do_not_take():
    """The texture taps' test launchers refuse, before any launch: the
    first bilinear form asked for with a nearest tap, and a direction tap
    of other than 3 channels."""
    from digital_earth_tpu_torch import kernels

    tex4, z3 = torch.zeros((4, 8, 4), dtype=torch.uint8), torch.zeros((2, 3))
    with pytest.raises(ValueError, match="first_form"):
        kernels.sphere_tap(tex4, z3, False, first_form=True)
    with pytest.raises(ValueError, match="first_form"):
        kernels.dir_tap(torch.zeros((4, 8, 3), dtype=torch.uint8), z3, False, first_form=True)
    with pytest.raises(ValueError, match="shape"):
        kernels.dir_tap(tex4, z3, True)


def _rmo_spans(case):
    t0, t1 = jpt._rmo_span(jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]),
                           jnp.full((N,), -1.0))
    return np.asarray(t0), np.asarray(t1)


def test_rmo_delta_track_matches_jax(case):
    t0, t1 = _rmo_spans(case)
    je, jt, jid = map(np.asarray, jpt._delta_track_rmo(
        case["jkeys"], jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]),
        jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(case["ext"]), None,
        jnp.asarray(case["active"]), JaxConfig(),
    ))
    te, tt, tid = (x.numpy() for x in tracers.delta_track_rmo(
        case["tkeys"], T(case["pos"]), T(case["dirs"]), T(t0), T(t1),
        T(case["ext"][:, 0, :]), T(case["active"]), TraceConfig(),
    ))
    assert 0.2 < (je > 0).mean() < 0.95
    assert (je == te).mean() >= 0.99
    assert (jid == tid)[je > 0].mean() >= 0.99
    ev = (je > 0) & (je == te)
    assert np.median(np.abs(tt[ev] - jt[ev]) / np.maximum(np.abs(jt[ev]), 1.0)) < 1e-5


def _cloud_both(case, mode):
    pos, dirs = jnp.asarray(case["pos"]), jnp.asarray(case["dirs"])
    cs, cm = jpt.intersect_cloud_limits(pos, dirs, jnp.full((N,), -1.0))
    ext_w = np.full((N,), C.CLOUDS_EXTINCT, np.float32)
    j = jpt._track_cloud(case["jkeys"], pos, dirs, cs, cm, jnp.asarray(ext_w), None,
                         case["jatlas"].clouds, jnp.asarray(case["active"]),
                         JaxConfig(), mode=mode)
    args = (case["tkeys"], T(case["pos"]), T(case["dirs"]), T(cs), T(cm), T(ext_w),
            case["tatlas"].clouds, T(case["active"]), TraceConfig(), mode)
    return j, args


def test_cloud_delta_track_matches_jax(case):
    (je, jt), args = _cloud_both(case, "delta")
    je, jt = np.asarray(je), np.asarray(jt)
    te, tt = (x.numpy() for x in tracers.track_cloud(*args))
    assert (je > 0).mean() > 0.05
    assert (je == te).mean() >= 0.99
    ev = (je > 0) & (je == te)
    assert np.median(np.abs(tt[ev] - jt[ev]) / np.maximum(jt[ev], 1.0)) < 1e-5


def test_cloud_ratio_track_matches_jax(case):
    j, args = _cloud_both(case, "ratio")
    t = tracers.track_cloud(*args).numpy()
    j = np.asarray(j)
    assert j.min() < 0.5  # some chords are optically thick
    assert abs(t.mean() - j.mean()) < 1e-3
    assert np.isclose(t, j, rtol=1e-4, atol=1e-6).mean() >= 0.99


@pytest.mark.parametrize("k,L", [(1, 1), (1, 4), (4, 1), (4, 4)])
def test_rmo_ratio_track_matches_jax(case, k, L):
    """The ratio tracker's twin against the reference's ``_ratio_track_rmo``
    on the case's lanes over their spans to space, at the packet majorant
    of the first L wavelengths: the share of (lane, wavelength) values
    within rtol 1e-4, atol 1e-6 (floor 0.99, as the cloud ratio tracker's;
    measured 0.9988-0.9995 over k and L, 0.20-0.45 bit-equal: the two
    libms round log and exp apart), and the mean within 1e-6 (measured
    3e-8 to 9e-8)."""
    from digital_earth_tpu_torch.models import volume as tvol

    t0, t1 = _rmo_spans(case)
    ext = np.ascontiguousarray(case["ext"][:, :L])
    j_max = np.asarray(jnp.max(jnp.sum(jnp.asarray(ext) * jpt._MAX_DENS_RMO, -1), -1))
    t_max = tvol.max_extinction_rmo(T(ext))
    np.testing.assert_array_equal(t_max.numpy(), j_max)
    j = np.asarray(jpt._ratio_track_rmo(
        case["jkeys"], jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]), jnp.asarray(t0),
        jnp.asarray(t1), jnp.asarray(ext), jnp.asarray(j_max), jnp.asarray(case["active"]),
        JaxConfig(tracking_k=k),
    ))
    t = tracers.ratio_track_rmo(
        case["tkeys"], T(case["pos"]), T(case["dirs"]), T(t0), T(t1), T(ext), t_max,
        T(case["active"]), TraceConfig(tracking_k=k),
    ).numpy()
    assert t.shape == j.shape == (N, L)
    assert j.min() < 0.5 < j.max()  # thick and thin chords, as the case mixes them
    assert np.isclose(t, j, rtol=1e-4, atol=1e-6).mean() >= 0.99
    assert abs(t.mean() - j.mean()) < 1e-6


# The stops the ratio tracker's kernel must keep (its card tests hold it bit
# for bit against the twin there): the cap of max_tracking_steps cutting
# lanes short, and lanes ending on the 1e-5 test (the extinctions of the
# even near-terrain lanes scaled up, so the case mixes thick and thin
# chords, and the thick ones end within a few dozen iterations).
@pytest.mark.parametrize("k,L,max_steps,scale", [
    (4, 4, 1, 1.0), (4, 4, 2, 1.0), (4, 1, 2, 1.0), (1, 4, 2, 1.0),
    (4, 4, 8192, 300.0), (4, 1, 8192, 300.0), (3, 4, 8192, 300.0),
])
def test_rmo_ratio_track_stops_match_jax(case, k, L, max_steps, scale):
    """The ratio tracker's twin against the reference's ``_ratio_track_rmo``
    where its lanes stop on the iteration cap or on the transmittance test,
    at the tolerance of ``test_rmo_ratio_track_matches_jax`` (the share of
    values within rtol 1e-4, atol 1e-6 at least 0.99, the mean within
    1e-6); each case reaches the stop it names."""
    from digital_earth_tpu_torch.models import volume as tvol

    t0, t1 = _rmo_spans(case)
    thick = (np.arange(N) >= N // 2) & (np.arange(N) % 2 == 0)
    ext = case["ext"][:, :L] * np.where(thick, scale, 1.0)[:, None, None]
    ext = np.ascontiguousarray(ext, np.float32)
    j_max = np.asarray(jnp.max(jnp.sum(jnp.asarray(ext) * jpt._MAX_DENS_RMO, -1), -1))
    t_max = tvol.max_extinction_rmo(T(ext))
    np.testing.assert_array_equal(t_max.numpy(), j_max)
    j = np.asarray(jpt._ratio_track_rmo(
        case["jkeys"], jnp.asarray(case["pos"]), jnp.asarray(case["dirs"]), jnp.asarray(t0),
        jnp.asarray(t1), jnp.asarray(ext), jnp.asarray(j_max), jnp.asarray(case["active"]),
        JaxConfig(tracking_k=k, max_tracking_steps=max_steps),
    ))
    args = (case["tkeys"], T(case["pos"]), T(case["dirs"]), T(t0), T(t1), T(ext), t_max,
            T(case["active"]))
    trips = torch.zeros(N, dtype=torch.int32)
    t = tracers.ratio_track_rmo_plain(
        *args, TraceConfig(tracking_k=k, max_tracking_steps=max_steps), trips=trips).numpy()
    assert t.shape == j.shape == (N, L)
    assert np.isclose(t, j, rtol=1e-4, atol=1e-6).mean() >= 0.99
    assert abs(t.mean() - j.mean()) < 1e-6
    trips = trips.numpy()
    if max_steps < 8192:  # lanes the cap cut short of their end
        full = torch.zeros(N, dtype=torch.int32)
        tracers.ratio_track_rmo_plain(*args, TraceConfig(tracking_k=k), trips=full)
        assert trips.max() == max_steps and (full.numpy() > max_steps).any()
    else:  # lanes that ended on the transmittance test, before t_max
        ended = (j.max(-1) < 1e-5) & (t.max(-1) < 1e-5)
        assert ended.any() and (trips[ended] < max_steps).all()
