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
