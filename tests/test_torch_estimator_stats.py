"""The statistical tests of the reference's estimator options in the port
(the JAX package's own, run on the port's twins on the CPU):

- tests/test_flight_analytic.py: the analytic flight
  (``tracers.sample_rmo_flight_analytic``) against the port's delta
  tracker on the fan of test_torch_estimator: the collision probability
  against Beer-Lambert, the distance deciles, the event and species rates,
  and no collision without a span;
- tests/test_tracking_equiv.py TestFastLoopRng: the counter hash's
  uniformity and decorrelation, and the accelerated trackers at
  fast_loop_rng against the port's naive twins (which keep threefry);
- tests/test_pathtracer.py::test_nee_off_diagnostic: nee_off can only lose
  energy lane by lane, on the same random streams.
"""

import dataclasses

import numpy as np
import torch

from digital_earth_tpu_torch import constants as C
from digital_earth_tpu_torch.assets.luts import load_spectral_luts
from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.models import atmosphere_lut as atm
from digital_earth_tpu_torch.ops import rng
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render import tracers
from digital_earth_tpu_torch.render import tracking_naive as tn
from digital_earth_tpu_torch.render.params import TraceConfig
from test_torch_estimator import fan  # noqa: F401  (fixture)
from test_torch_naive import TestRmoTrackers, _cloud_spans, _keys
from test_torch_naive import equiv  # noqa: F401  (fixture)

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# tests/test_flight_analytic.py: the analytic flight against the port's
# delta tracker
# ---------------------------------------------------------------------------


def _run(fan, analytic: bool, seed: int):
    t, n = fan["t"], fan["n"]
    keys = rng.lane_keys(rng.prng_key(seed, "cpu"), torch.arange(n))
    args = (keys, t["pos"], t["d"], t["t_start"], t["t_max"], t["ext"][:, 0, :].contiguous(),
            torch.ones(n, dtype=torch.bool))
    if analytic:
        out = tracers.sample_rmo_flight_analytic(*args, TraceConfig(analytic_flight=True))
    else:
        out = tracers.delta_track_rmo(*args, TraceConfig())
    return tuple(x.numpy() for x in out)


class TestAnalyticFlight:
    def test_collision_probability_matches_beer_lambert(self, fan):
        """P(collision) per ray is 1 - exp(-tau_total): the binned empirical
        rate over 32 seeds against the analytic value."""
        t, n = fan["t"], fan["n"]
        _, _, tau_total = atm.sample_flight_distance_plain(
            torch.full((n,), 0.5), t["pos"], t["d"], t["t_start"], t["t_max"],
            t["ext"][:, 0, :].contiguous())
        p_ana = (1.0 - torch.exp(-tau_total)).numpy()
        hits = np.zeros(n)
        n_seeds = 32
        for s in range(n_seeds):
            ev, _, _ = _run(fan, True, s)
            hits += ev != tracers.NULL_EVENT
        p_emp = hits / n_seeds
        for b in np.array_split(np.arange(n), 16):
            m_emp, m_ana = p_emp[b].mean(), p_ana[b].mean()
            se = np.sqrt(max(m_ana * (1 - m_ana), 1e-6) / (len(b) * n_seeds))
            assert abs(m_emp - m_ana) < 5 * se + 1e-3, (m_emp, m_ana, se)

    def test_distance_distribution_matches_delta_tracking(self, fan):
        """Collision-distance deciles agree between the two samplers."""
        ta, td = [], []
        for s in range(8):
            ev_a, t_a, _ = _run(fan, True, s)
            ev_d, t_d, _ = _run(fan, False, 1000 + s)
            ta.append(t_a[ev_a != tracers.NULL_EVENT])
            td.append(t_d[ev_d != tracers.NULL_EVENT])
        ta, td = np.concatenate(ta), np.concatenate(td)
        qa = np.quantile(ta, np.linspace(0.1, 0.9, 9))
        qd = np.quantile(td, np.linspace(0.1, 0.9, 9))
        np.testing.assert_allclose(qa, qd, rtol=0.03)

    def test_event_and_species_rates_match(self, fan):
        """The scatter / absorb split and the species fractions agree."""
        ca, cd = [], []
        for s in range(8):
            ev_a, _, id_a = _run(fan, True, s)
            ev_d, _, id_d = _run(fan, False, 1000 + s)
            ca.append((ev_a, id_a))
            cd.append((ev_d, id_d))
        ev_a = np.concatenate([c[0] for c in ca])
        id_a = np.concatenate([c[1] for c in ca])[ev_a != tracers.NULL_EVENT]
        ev_d = np.concatenate([c[0] for c in cd])
        id_d = np.concatenate([c[1] for c in cd])[ev_d != tracers.NULL_EVENT]
        ra = np.bincount(id_a, minlength=3) / id_a.size
        rd = np.bincount(id_d, minlength=3) / id_d.size
        np.testing.assert_allclose(ra, rd, atol=0.02)
        sa = (ev_a == tracers.SCATTER_EVENT).mean()
        sd = (ev_d == tracers.SCATTER_EVENT).mean()
        assert abs(sa - sd) < 0.02, (sa, sd)

    def test_no_span_rays_never_collide(self, fan):
        t, n = fan["t"], fan["n"]
        u = rng.uniform_key(rng.prng_key(0, "cpu"), (n,))
        _, collided, tau = atm.sample_flight_distance_plain(
            u, t["pos"], t["d"], torch.zeros(n), torch.full((n,), -1.0),
            t["ext"][:, 0, :].contiguous())
        assert not bool(collided.any())
        assert np.allclose(tau.numpy(), 0.0)


# ---------------------------------------------------------------------------
# tests/test_tracking_equiv.py TestFastLoopRng: the trackers at
# fast_loop_rng against the port's naive twins
# ---------------------------------------------------------------------------

CFG = TraceConfig(max_tracking_steps=4096)


class TestFastLoopRng:
    CFGF = TraceConfig(max_tracking_steps=4096, fast_loop_rng=True)

    def test_uniformity_and_decorrelation(self):
        keys = _keys(11, 512)
        us = torch.stack([rng.fast_uniform(keys, i, (3, 4)) for i in range(16)]).numpy()
        flat = us.reshape(-1)
        assert 0.0 <= flat.min() and flat.max() < 1.0
        assert abs(flat.mean() - 0.5) < 3.0 / np.sqrt(flat.size)
        assert abs(flat.var() - 1.0 / 12.0) < 0.002
        h, _ = np.histogram(flat, bins=32, range=(0.0, 1.0))
        exp = flat.size / 32.0
        chi2 = ((h - exp) ** 2 / exp).sum()
        assert chi2 < 32 + 5 * np.sqrt(2 * 32)
        for ax in range(4):
            a = np.moveaxis(us, ax, 0)
            x = a[:-1].reshape(-1) - 0.5
            y = a[1:].reshape(-1) - 0.5
            r = (x * y).mean() / (x.std() * y.std() + 1e-12)
            assert abs(r) < 5.0 / np.sqrt(x.size), (ax, r)

    def test_cloud_delta_matches_naive(self, equiv):  # noqa: F811
        atlas, nvec = equiv
        reps = 3000
        o, d, ts, tm = _cloud_spans(nvec * (C.PLANET_R + 100.0), nvec, reps)
        ext_w = torch.full((reps,), C.CLOUDS_EXTINCT)
        act = torch.ones(reps, dtype=torch.bool)
        e_f, t_f = tracers.track_cloud(_keys(7, reps), o, d, ts, tm, ext_w, atlas.clouds, act,
                                       self.CFGF, "delta")
        ext4 = torch.zeros((reps, 4))
        ext4[:, 3] = C.CLOUDS_EXTINCT
        e_n, t_n, _ = tn.delta_track_naive(_keys(8, reps), o, d, ts, tm, ext4,
                                           ext_w * C.CLOUDS_DENSITY, atlas.clouds, "cloud", act,
                                           CFG)
        e_f, e_n, t_f, t_n = (x.numpy() for x in (e_f, e_n, t_f, t_n))
        p_f, p_n = (e_f > 0).mean(), (e_n > 0).mean()
        se = np.sqrt(p_n * (1 - p_n) / reps) + 1e-6
        assert abs(p_f - p_n) < 5 * se + 0.01
        m_f, m_n = t_f[e_f > 0].mean(), t_n[e_n > 0].mean()
        s = t_n[e_n > 0].std() / np.sqrt((e_n > 0).sum()) + 1e-3
        assert abs(m_f - m_n) < 6 * s + 0.01 * abs(m_n)

    def test_rmo_trackers_match_naive(self, equiv):  # noqa: F811
        atlas, _ = equiv
        reps = 3000
        o, d, ts, tm, ext, max_ext = TestRmoTrackers()._setup_rays(reps)
        act = torch.ones(reps, dtype=torch.bool)
        e_f, _, _ = tracers.delta_track_rmo(_keys(3, reps), o, d, ts, tm, ext, act, self.CFGF)
        ext4 = torch.cat([ext, torch.zeros((reps, 1))], dim=-1)
        e_n, _, _ = tn.delta_track_naive(_keys(4, reps), o, d, ts, tm, ext4, max_ext,
                                         atlas.clouds, "rmo", act, CFG)
        e_f, e_n = e_f.numpy(), e_n.numpy()
        for ev in (1, 2):
            p_f, p_n = (e_f == ev).mean(), (e_n == ev).mean()
            se = np.sqrt(max(p_n * (1 - p_n), 1e-6) / reps)
            assert abs(p_f - p_n) < 5 * se + 0.01, (ev, p_f, p_n)
        tr_f = tracers.ratio_track_rmo(_keys(1, reps), o, d, ts, tm, ext[:, None, :], max_ext,
                                       act, self.CFGF)[:, 0]
        tr_n = tn.ratio_track_naive(_keys(2, reps), o, d, ts, tm, ext4, max_ext, atlas.clouds,
                                    "rmo", act, CFG)
        f, nv = tr_f.numpy(), tr_n.numpy()
        se = (f.std() + nv.std()) / np.sqrt(reps) + 1e-4
        assert abs(f.mean() - nv.mean()) < 5 * se


# ---------------------------------------------------------------------------
# tests/test_pathtracer.py::test_nee_off_diagnostic
# ---------------------------------------------------------------------------


def _trace_paths(key, pos, dirs, wl, scene, atlas, luts, cfg):
    """The reference's ``trace_paths`` in the port: single-wavelength paths
    from lane keys ``fold(key, i)``, every bounce, the primary misses
    shaded, the radiance clamped (the bounces advance the state in place:
    the rays are copied)."""
    st = pt.init_state(pos.clone(), dirs.clone(), wl[:, None], torch.ones_like(wl[:, None]),
                       rng.lane_keys(key, torch.arange(pos.shape[0])))
    st = pt.run_bounces(st, scene, atlas, luts, cfg, 0, cfg.max_bounces)
    st = pt.shade_primary_miss(st, scene, atlas, luts, cfg)
    return pt.finalize_radiance(st)[:, 0]


def test_nee_off_diagnostic():
    """nee_off drops the sun's NEE: the render stays finite, and with the
    same random streams each lane can only lose energy against the default
    estimator."""
    from digital_earth_tpu_torch.render.params import make_scene_params

    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), "cpu")
    luts = load_spectral_luts("cpu")
    scene = make_scene_params("cpu")
    n = 256
    cam = torch.tensor([35963490.0, 12765367.0, -42445899.0])
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(n, 3)).astype(np.float32))
    dirs = g * 5e6 - cam
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    pos = cam.expand(n, 3).contiguous()
    wl = torch.linspace(400.0, 700.0, n)
    cfg = TraceConfig(hero_lambdas=1, max_bounces=4, max_tracking_steps=512,
                      land_march_steps=64)
    key = rng.prng_key(7, "cpu")
    on = _trace_paths(key, pos, dirs, wl, scene, atlas, luts, cfg).numpy()
    off = _trace_paths(key, pos, dirs, wl, scene, atlas, luts,
                       dataclasses.replace(cfg, nee_off=True)).numpy()
    assert np.isfinite(off).all() and (off >= 0).all()
    assert (off <= on + 1e-6).all()
    assert off.sum() < on.sum()
