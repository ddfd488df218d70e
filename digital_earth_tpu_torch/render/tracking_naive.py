"""The reference-faithful trackers (port of
digital_earth_tpu/render/tracking_naive.py): the reference renderer's
per-thread loops, one step an iteration at the global majorant, and its
plain sphere march. ``TraceConfig(naive_tracking=True)`` runs them in place
of the accelerated loops; ``naive_march``, ``naive_cloud_tracking`` and
``naive_shadow`` swap one subsystem each (render/pathtracer.py dispatches).

- ``intersect_land_naive``: an RSI warm start on the atmosphere shell, then
  up to ``land_march_steps`` steps of the signed SDF (tracking_naive.py:31)
  -> kernel ``naive_march``;
- ``delta_track_naive``: Woodcock tracking at the global majorant, three
  draws a step (:72) -> kernel ``naive_delta_track``;
- ``ratio_track_naive``: ratio tracking at the global majorant, one draw a
  step (:126) -> kernel ``naive_ratio_track``.

Each tracker takes the species ``"rmo"`` (the gases' analytic densities,
channels 0-2 of the (n, 4) extinctions) or ``"cloud"`` (one tap of the
cloud map's channel 0 and the split-shape density, channel 3). A wrapper
takes the plain version for tensors on the CPU and launches the kernel
(``digital_earth_tpu_torch.kernels``) for CUDA tensors. On the card the
bounce kernels' options instances run the same loops as device functions
(csrc/naive.cuh); the launchers serve the bounce's plain twin and the
comparison with these plain versions.

The plain versions iterate over the still-live lanes (``tracers._run_lanes``)
and round each step as the kernels do: a lane's total extinction is summed
left to right over its species' channels.
"""

from __future__ import annotations

import torch

from .. import constants as C
from .. import kernels
from ..models import volume as vol
from ..ops import rng
from ..ops import texture as tx
from ..ops.math_utils import length, rsi
from .params import TraceConfig
from .tracers import (ABSORB_EVENT, NULL_EVENT, SCATTER_EVENT, _ALBEDOS, _MAX_RAY_DIST,
                      _run_lanes, cloud_shape_density)

SPECIES = ("rmo", "cloud")


def intersect_land_naive_plain(topo, pos, direction, scale, active, cfg: TraceConfig,
                               trips=None):
    """Plain PyTorch twin of the ``naive_march`` kernel: the hit distance,
    -1 on a miss or without land. ``trips`` (n,) int32: each lane's steps
    are added there."""
    from .pathtracer import land_sdf  # the SDF the accelerated march shares

    n = pos.shape[0]
    if not cfg.enable_land:
        return torch.full((n,), -1.0, device=pos.device)
    a_near, _ = rsi(pos, direction, C.ATMOS_UPPER_LIMIT)
    t0 = torch.where(a_near > 0.0, a_near, 0.0)

    def body(i, s, c):
        ro = c["pos"] + s["t"][:, None] * c["dir"]
        dist = land_sdf(topo, ro, scale, cfg.bilinear_tracking)
        t_new = s["t"] + dist
        stop = (t_new > _MAX_RAY_DIST) | (torch.abs(dist) < t_new * 1e-4)
        return dict(t=t_new, done=stop)

    state = _run_lanes(cfg.land_march_steps, 1, dict(t=t0.clone(), done=~active),
                       dict(pos=pos, dir=direction), body, trips)
    t = state["t"]
    return torch.where(active & (t < _MAX_RAY_DIST), t, -1.0)


def intersect_land_naive(topo, pos, direction, scale, active, cfg: TraceConfig):
    """The plain sphere march's hit distance along each ray (-1 on a miss).
    CPU tensors: the plain version; CUDA tensors: the ``naive_march``
    kernel."""
    if pos.device.type == "cpu":
        return intersect_land_naive_plain(topo, pos, direction, scale, active, cfg)
    return kernels.naive_march(topo, pos, direction, active, float(scale),
                               steps=cfg.land_march_steps, enable=cfg.enable_land,
                               bilinear=cfg.bilinear_tracking)


def _check_species(species):
    if species not in SPECIES:
        raise ValueError(f"unknown species {species!r}: expected one of {SPECIES}")


def _total(species, pos, ext, clouds, bilinear):
    """The lane's total extinction at ``pos`` and, for the gases, the three
    species' terms."""
    if species == "rmo":
        terms = vol.get_density(vol.get_elevation(pos)) * ext[:, :3]
        return terms[:, 0] + terms[:, 1] + terms[:, 2], terms
    tap = tx.sample_sphere_texture(clouds, pos, bilinear=bilinear)[..., 0]
    return ext[:, 3] * cloud_shape_density(tap, length(pos)), None


def _setup(keys, t_start, t_max, max_extinction, active):
    n = t_start.shape[0]
    keys = rng.as_lane_keys(keys, n)
    valid = active & (t_max >= 0.0) & (t_start < t_max)
    max_ext = torch.as_tensor(max_extinction, dtype=torch.float32,
                              device=t_start.device).expand(n)
    return keys, valid, max_ext


def delta_track_naive_plain(keys, ray_pos, ray_dir, t_start, t_max, extinctions,
                            max_extinction, clouds, species, active, cfg: TraceConfig,
                            trips=None):
    """Plain PyTorch twin of the ``naive_delta_track`` kernel: (event, t,
    iid) of one-step Woodcock tracking at ``max_extinction`` over [t_start,
    t_max]. ``keys`` (n, 2) or one (2,) key; ``extinctions`` (n, 4); step i
    draws uniform(fold(key, i), (3,)). ``trips`` (n,) int32: each lane's
    steps are added there."""
    _check_species(species)
    keys, valid, max_ext = _setup(keys, t_start, t_max, max_extinction, active)
    n = t_start.shape[0]
    dev = t_start.device
    albedos = _ALBEDOS.to(dev)

    def body(i, s, c):
        u = rng.uniform(rng.fold(c["keys"], i), (3,))  # (3, m)
        t_new = s["t"] - torch.log(torch.clamp(u[0], min=1e-12)) * c["inv_max"]
        over = t_new >= c["t_max"]
        pos = c["pos"] + torch.minimum(t_new, c["tms"])[:, None] * c["dir"]
        total, terms = _total(species, pos, c["ext"], clouds, cfg.bilinear_tracking)
        real = u[1] < total * c["inv_max"]
        if species == "rmo":
            r = u[1] * c["max_ext"]
            c0 = terms[:, 0]
            c01 = c0 + terms[:, 1]
            iid_new = torch.where(r < c0, C.RAYLEIGH_ID,
                                  torch.where(r < c01, C.MIE_ID, C.OZONE_ID))
        else:
            iid_new = torch.full_like(s["iid"], C.CLOUD_ID, dtype=torch.int64)
        scatters = u[2] < albedos[iid_new]
        hit = ~over & real
        event = torch.where(hit, torch.where(scatters, SCATTER_EVENT, ABSORB_EVENT),
                            s["event"]).to(torch.int32)
        iid = torch.where(hit, iid_new, s["iid"]).to(torch.int32)
        return dict(t=t_new, done=over | hit, event=event, iid=iid)

    state = dict(t=t_start.clone(), done=~valid,
                 event=torch.full((n,), NULL_EVENT, dtype=torch.int32, device=dev),
                 iid=torch.zeros((n,), dtype=torch.int32, device=dev))
    ctx = dict(keys=keys, pos=ray_pos, dir=ray_dir, t_max=t_max,
               tms=torch.clamp(t_max, min=0.0), ext=extinctions, max_ext=max_ext,
               inv_max=1.0 / max_ext)
    state = _run_lanes(cfg.max_tracking_steps, 1, state, ctx, body, trips)
    return state["event"], state["t"], state["iid"]


def ratio_track_naive_plain(keys, ray_pos, ray_dir, t_start, t_max, extinctions,
                            max_extinction, clouds, species, active, cfg: TraceConfig,
                            trips=None):
    """Plain PyTorch twin of the ``naive_ratio_track`` kernel: the (n,)
    transmittance over [t_start, t_max] by one-step ratio tracking at
    ``max_extinction``; step i draws uniform(fold(key, i)), and a lane stops
    past t_max or once its transmittance is below 1e-5. Arguments as
    ``delta_track_naive_plain`` takes them."""
    _check_species(species)
    keys, valid, max_ext = _setup(keys, t_start, t_max, max_extinction, active)

    def body(i, s, c):
        u = rng.uniform(rng.fold(c["keys"], i))  # (m,)
        t_new = s["t"] - torch.log(torch.clamp(u, min=1e-12)) * c["inv_max"]
        over = t_new >= c["t_max"]
        pos = c["pos"] + torch.minimum(t_new, c["tms"])[:, None] * c["dir"]
        total, _ = _total(species, pos, c["ext"], clouds, cfg.bilinear_tracking)
        trans = torch.where(over, s["trans"], s["trans"] * (1.0 - total * c["inv_max"]))
        done = over | (trans < 1e-5)
        return dict(t=torch.where(done, s["t"], t_new), done=done, trans=trans)

    state = dict(t=t_start.clone(), done=~valid, trans=torch.ones_like(t_start))
    ctx = dict(keys=keys, pos=ray_pos, dir=ray_dir, t_max=t_max,
               tms=torch.clamp(t_max, min=0.0), ext=extinctions, inv_max=1.0 / max_ext)
    state = _run_lanes(cfg.max_tracking_steps, 1, state, ctx, body, trips)
    return state["trans"]


def _kernel_track(keys, ray_pos, ray_dir, t_start, t_max, extinctions, max_extinction,
                  clouds, species, active, cfg, launcher):
    n = t_start.shape[0]
    return launcher(rng.as_lane_keys(keys, n), ray_pos, ray_dir, t_start, t_max,
                    extinctions, torch.as_tensor(max_extinction, dtype=torch.float32,
                                                 device=t_start.device).expand(n).contiguous(),
                    active, clouds, species=species, max_steps=cfg.max_tracking_steps,
                    bilinear=cfg.bilinear_tracking)


def delta_track_naive(keys, ray_pos, ray_dir, t_start, t_max, extinctions, max_extinction,
                      clouds, species, active, cfg: TraceConfig):
    """(event, t, iid) of one-step Woodcock tracking at the global majorant.
    CPU tensors: the plain version; CUDA tensors: the ``naive_delta_track``
    kernel."""
    args = (keys, ray_pos, ray_dir, t_start, t_max, extinctions, max_extinction, clouds,
            species, active, cfg)
    if ray_pos.device.type == "cpu":
        return delta_track_naive_plain(*args)
    return _kernel_track(*args, kernels.naive_delta_track)


def ratio_track_naive(keys, ray_pos, ray_dir, t_start, t_max, extinctions, max_extinction,
                      clouds, species, active, cfg: TraceConfig):
    """The (n,) transmittance by one-step ratio tracking at the global
    majorant. CPU tensors: the plain version; CUDA tensors: the
    ``naive_ratio_track`` kernel."""
    args = (keys, ray_pos, ray_dir, t_start, t_max, extinctions, max_extinction, clouds,
            species, active, cfg)
    if ray_pos.device.type == "cpu":
        return ratio_track_naive_plain(*args)
    return _kernel_track(*args, kernels.naive_ratio_track)
