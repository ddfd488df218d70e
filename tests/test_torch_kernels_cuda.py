"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and ``nvcc`` and skips without one (the
kernels have no CPU mode). The file imports no JAX, so on a machine without
it run it as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Stated tolerances (kernel vs twin, same inputs, same CUDA libm, op-by-op
rounding on both sides): hit/miss and event agreement >= 99.9%, median
relative distance error < 1e-6, mean ratio transmittance within 1e-4; the
threefry header is bit-equal.
"""

import os

import numpy as np
import pytest
import torch

from digital_earth_tpu_torch import constants as C
from digital_earth_tpu_torch.app.config_io import load_config
from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
from digital_earth_tpu_torch.assets.luts import load_spectral_luts
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.models import volume as vol
from digital_earth_tpu_torch.ops import rng
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render import tracers
from digital_earth_tpu_torch.render.params import TraceConfig

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16384


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def case(dev):
    """Orbit rays at the limb and disk plus near-terrain rays in random
    directions, as tests/test_torch_tracers.py builds them."""
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
    dirs = np.concatenate([d0, unit(N - h)])
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dev, dt)  # noqa: E731
    wl = t(r.uniform(390.0, 830.0, (N, 4)))
    luts = load_spectral_luts(dev)
    ext = torch.stack([
        vol.spectra_extinction_rayleigh(wl), vol.spectra_extinction_mie(wl),
        vol.spectra_extinction_ozone(wl, luts.o3_crossec),
    ], dim=-1)
    return dict(
        pos=t(pos), dirs=t(dirs), active=t(r.random(N) < 0.95, torch.bool),
        ext_h=ext[:, 0, :].contiguous(),
        atlas=build_atlas(generate_earth_textures((128, 256), seed=3), dev),
        keys=rng.lane_keys(rng.prng_key(5, dev), torch.arange(N, device=dev)),
    )


def test_threefry_header_bit_equal(dev):
    from digital_earth_tpu_torch import kernels

    keys = rng.lane_keys(rng.prng_key(7, dev), torch.arange(4096, device=dev) * 7919)
    for data in (0, 5, 0xFFFFFFFF):
        got = kernels.threefry_uniform(keys, data, 12)
        want = rng.uniform(rng.fold(keys, data), (12,))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("any_hit,capped", [(False, False), (True, False), (False, True)])
def test_land_march_kernel(case, any_hit, capped):
    from digital_earth_tpu_torch import kernels

    t_cap = None
    if capped:
        t_cap = torch.rand(N, device=case["pos"].device) * 3e7 + 1e3
    args = (case["atlas"].topography, case["pos"], case["dirs"],
            torch.tensor(7800.0, device=case["pos"].device), case["active"],
            TraceConfig())
    before = kernels.land_march.launches
    got = tracers.intersect_land(*args, t_cap=t_cap, any_hit=any_hit)
    assert kernels.land_march.launches == before + 1
    want = tracers.intersect_land_plain(*args, t_cap=t_cap, any_hit=any_hit)
    assert ((got >= 0) == (want >= 0)).float().mean().item() >= 0.999
    both = (got >= 0) & (want >= 0)
    rel = ((got - want).abs() / want.clamp(min=1.0))[both]
    assert rel.median().item() < 1e-6


def test_rmo_delta_track_kernel(case):
    t0, t1 = pt._rmo_span(case["pos"], case["dirs"],
                          torch.full((N,), -1.0, device=case["pos"].device))
    args = (case["keys"], case["pos"], case["dirs"], t0, t1, case["ext_h"],
            case["active"], TraceConfig())
    ge, gt, gid = tracers.delta_track_rmo(*args)
    we, wt, wid = tracers.delta_track_rmo_plain(*args)
    assert (ge == we).float().mean().item() >= 0.999
    same = (ge == we) & (ge > 0)
    assert (gid == wid)[same].float().mean().item() >= 0.999
    assert ((gt - wt).abs() / wt.abs().clamp(min=1.0))[same].median().item() < 1e-6


@pytest.mark.parametrize("mode", ["delta", "ratio"])
def test_cloud_track_kernel(case, mode):
    no_land = torch.full((N,), -1.0, device=case["pos"].device)
    cs, cm = pt.intersect_cloud_limits(case["pos"], case["dirs"], no_land)
    ext_w = torch.full((N,), C.CLOUDS_EXTINCT, device=case["pos"].device)
    args = (case["keys"], case["pos"], case["dirs"], cs, cm, ext_w,
            case["atlas"].clouds, case["active"], TraceConfig(), mode)
    got = tracers.track_cloud(*args)
    want = tracers.track_cloud_plain(*args)
    if mode == "delta":
        assert (got[0] == want[0]).float().mean().item() >= 0.999
        same = (got[0] == want[0]) & (got[0] > 0)
        rel = ((got[1] - want[1]).abs() / want[1].clamp(min=1.0))[same]
        assert rel.median().item() < 1e-6
    else:
        assert abs(got.mean().item() - want.mean().item()) < 1e-4


def test_launchers_check_their_inputs(case):
    from digital_earth_tpu_torch import kernels

    n = 8
    ok = dict(step_floor=100.0, stall_thresh=25.0, steps=16, k=4, patience=2,
              any_hit=False)
    topo = case["atlas"].topography
    pos = case["pos"][:n].contiguous()
    act = case["active"][:n].contiguous()
    cap = torch.full((n,), float("inf"), device=pos.device)
    with pytest.raises(ValueError, match="dtype"):
        kernels.land_march(topo, pos.double(), pos, act, cap, 7800.0, **ok)
    with pytest.raises(ValueError, match="contiguous"):
        strided = case["pos"][: 2 * n : 2]
        kernels.land_march(topo, strided, pos, act, cap, 7800.0, **ok)
    with pytest.raises(ValueError, match="shape"):
        kernels.land_march(topo, pos, pos, act[:4], cap, 7800.0, **ok)
    with pytest.raises(ValueError, match="expected"):
        kernels.land_march(topo, pos.cpu(), pos, act, cap, 7800.0, **ok)


def test_main_path_uses_every_kernel_and_matches_golden(dev):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.viewer import render_offline

    golden = np.load(os.path.join(ROOT, "tests", "golden", "apollo_path.npz"))
    kernels.reset_launch_counts()
    r = render_offline(
        load_config(os.path.join(ROOT, "scenes", "config - Apollo 11.txt")), dev,
        spp=int(golden["spp"]), image_res=(32, 18), out_path=None,
        atlas=build_atlas(generate_earth_textures((64, 128), seed=3), dev), seed=0,
        cfg=TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256),
    )
    assert all(v > 0 for v in kernels.launch_counts().values())
    buf = r.color_buffer.cpu().numpy()
    share = np.isclose(buf, golden["color_buffer"], rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= 0.90
