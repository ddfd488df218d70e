"""The march floors (``TraceConfig`` march_certified_floor with
march_uncert_floor_frac, and march_floor_frac_secondary) in whole frames, on
the CPU (test_torch_floors.py holds the march, test_torch_floors_bounce.py
the bounce): one 32x18 spp of sunset (3 bounces) against the JAX renderer at
cert_u0 and at floor_pri05_sec005, and a (4, 1) mesh at the floors
bit-equal to the Renderer, as test_torch_mesh.py holds the default.
"""

import numpy as np
import pytest
import torch

from test_torch_floors import SETTINGS
from test_torch_mesh import _mesh, _single
from test_torch_mesh import atlases as mesh_atlases  # noqa: F401  (fixture)
from test_torch_naive import FRAME_BUDGETS, _frame, _port_frame
from test_torch_options import SUNSET

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

FRAME_FLOORS = {"cert_u0": 0.86, "floor_pri05_sec005": 0.86}


@pytest.mark.parametrize("name", sorted(FRAME_FLOORS))
def test_frame_at_march_floor_matches_jax_renderer(name):
    """One 32x18 spp of sunset (3 bounces) at a setting against the JAX
    renderer on the same 64x128 atlas: the share of pixels within rtol 1e-3
    (measured 0.873 at cert_u0 and 0.875 at floor_pri05_sec005, floor 0.86)
    and the channel means within 1% (measured 0.026%). The port's frame at
    the default config against the same JAX frame: 0.691 and 0.733, under
    the floor."""
    options = dict(SETTINGS[name], **FRAME_BUDGETS)
    got, want = _frame(SUNSET, options)
    assert np.isfinite(got).all() and got.shape == want.shape
    share = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert share >= FRAME_FLOORS[name], share
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    default = _port_frame(SUNSET, FRAME_BUDGETS)
    unmoved = np.isclose(default, want, rtol=1e-3, atol=1e-7).all(-1).mean()
    assert unmoved < FRAME_FLOORS[name], unmoved


def test_mesh_at_march_floors_matches_renderer(mesh_atlases):  # noqa: F811
    """A (4, 1) mesh at cert25_u0 with a secondary floor bit-equal to the
    Renderer over a spp at 16x8; the frame differs from the default config's
    (on 3 of its 384 values; cert_u0 leaves this small frame as it was)."""
    options = dict(SETTINGS["cert25_u0"], march_floor_frac_secondary=0.005)
    r, s = _mesh(mesh_atlases, 4, res=(16, 8), options=options), _single(
        mesh_atlases, (16, 8), options=options)
    r.accumulate()
    s.accumulate()
    assert s.color_buffer.any() and torch.equal(r.color_buffer, s.color_buffer)
    default = _single(mesh_atlases, (16, 8))
    default.accumulate()
    assert not torch.equal(default.color_buffer, s.color_buffer)
