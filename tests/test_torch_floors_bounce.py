"""The march floors (``TraceConfig`` march_certified_floor with
march_uncert_floor_frac, and march_floor_frac_secondary) through the port's
bounce, against the JAX package on the CPU (test_torch_floors.py holds the
march itself, test_torch_floors_frame.py whole frames): one bounce (the
32x18 golden frame's wavefront on the 64x128 atlas of seed 3,
test_torch_options._port_bounce) at bounces 0 and 3 on the three scenes
against the eager reference's bounce on the same lanes, held to
``test_torch_bounce._hold_to_floors``; where the setting acts enough, the
reference at the setting parts from the reference at the default by more
than the floor's slack.
"""

import pytest
import torch

from test_torch_bounce import _hold_to_floors, raw_atlas  # noqa: F401  (fixture)
from test_torch_floors import SETTINGS
from test_torch_naive import APOLLO
from test_torch_options import FLORIDA, SUNSET, _eager, _on, _port_bounce, _share

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

# (scene, bounce, setting) -> ((radiance, throughput) floors of the share of
# lanes within rtol 1e-3, whether the reference at the setting parts from
# its default by more than the floors' slack there); the measured shares are
# in the docstring
BOUNCE_CASES = {
    (SUNSET, 0, "cert_u0"): ((0.98, 0.99), True),
    (SUNSET, 0, "floor_pri05_sec005"): ((0.98, 0.99), True),
    (SUNSET, 3, "cert_u001"): ((0.99, 0.99), True),
    (SUNSET, 3, "floor_sec01"): ((0.99, 0.99), True),
    (APOLLO, 0, "floor_pri05_sec005"): ((0.95, 0.96), False),
    (FLORIDA, 0, "cert25_u0"): ((0.99, 0.99), False),
}
_eager_default = {}


@pytest.mark.parametrize("scene,bounce,name", list(BOUNCE_CASES))
def test_bounce_at_march_floor_matches_eager_reference(raw_atlas, scene, bounce,  # noqa: F811
                                                       name):
    """The port's bounce at one setting against the eager reference's on the
    lanes entering it (shares of lanes within rtol 1e-3, radiance and
    throughput; then the reference at the setting against the reference at
    the default, radiance and throughput):

    ==================  ==========  ============  ============
    setting             lanes       port vs ref   ref vs default
    ==================  ==========  ============  ============
    cert_u0             sunset 0    0.988, 1.000  0.863, 0.691
    floor_pri05_sec005  sunset 0    0.988, 1.000  0.913, 0.707
    cert_u001           sunset 3    0.996, 1.000  0.951, 0.845
    floor_sec01         sunset 3    1.000, 1.000  1.000, 0.938
    floor_pri05_sec005  Apollo 0    0.957, 0.965  0.988, 0.988
    cert25_u0           florida 0   1.000, 1.000  1.000, 1.000
    ==================  ==========  ============  ============

    sunset's grazing sun puts its camera and shadow rays where the floors
    act. Apollo's bounce-0 lanes part where test_torch_bounce's do (its
    floors 0.95), and the loose primary floor moves 0.012 of them, under that
    slack; florida's bounce-0 lanes on this atlas take no floor step any of
    the five settings changes (the reference at each equals its default
    there), so these two are held for agreement only. The secondary floor
    acts past bounce 0 alone."""
    floors, acts = BOUNCE_CASES[(scene, bounce, name)]
    options = SETTINGS[name]
    got = _port_bounce(raw_atlas, scene, options, bounce)
    want = _eager(raw_atlas, scene, got["in"], options, bounce)
    lanes = got["in"]["alive"]
    port, ref = _on(got["out"], lanes), _on(want, lanes)
    _hold_to_floors({"out": (port.radiance, port.throughput),
                     "class": (port.alive, port.work_class)}, ref, floors)
    if not acts:
        return
    if (scene, bounce) not in _eager_default:
        _eager_default[(scene, bounce)] = _eager(raw_atlas, scene, got["in"], {}, bounce)
    default = _on(_eager_default[(scene, bounce)], lanes)
    same = min(_share(ref.radiance, default.radiance),
               _share(ref.throughput, default.throughput))
    assert 1.0 - same > 1.0 - min(floors), same
