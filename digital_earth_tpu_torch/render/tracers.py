"""The three per-lane tracing loops of the bounce, each as a plain PyTorch
version and a wrapper that launches the hand-written CUDA kernel
(``csrc/``) for CUDA tensors:

- ``intersect_land``: displaced-sphere march + phantom crawl
  (digital_earth_tpu/render/pathtracer.py:211 intersect_land, :515
  _phantom_crawl) -> kernel ``land_march``;
- ``delta_track_rmo``: Woodcock flight through Rayleigh/Mie/ozone with the
  local hero majorant (pathtracer.py:631 _delta_track_rmo) -> kernel
  ``rmo_delta_track``;
- ``track_cloud``: space-skipping cloud-slab tracking, delta and ratio modes
  (pathtracer.py:906 _track_cloud) -> kernel ``cloud_track``.

The reference runs each as a masked ``lax.while_loop`` that repeats while
ANY lane is unfinished, drawing K speculative probes per iteration. Every
lane's loop only reads its own state and a shared iteration counter, so the
plain versions here iterate over the still-live lanes only, and the kernels
run one thread per lane to its own end. Both keep the K-probe results: the
same probe positions, the same first-stopping probe, the same threefry draw
``uniform(fold(key, i), (3, K))`` for lane iteration i.

A wrapper takes the plain version only for tensors on the CPU; a CUDA tensor
launches the kernel (``digital_earth_tpu_torch.kernels``) or raises.
"""

from __future__ import annotations

import math

import torch

from .. import constants as C

from .. import kernels
from ..models import atmosphere_lut as atm
from ..models import volume as vol
from ..ops import rng
from ..ops import texture as tx
from ..ops.math_utils import cross, dot, length, rsi
from .params import TraceConfig

NULL_EVENT = 0
ABSORB_EVENT = 1
SCATTER_EVENT = 2

# Validity radii of the topography max-mips (assets/textures.py MIP_*).
_MIP_VALID_FINE = 25e3
_MIP_VALID_COARSE = 115e3
_PHANTOM_PRUNE_ALT = 16e3
_MARCH_STALL_PATIENCE = 2  # reference TraceConfig.march_stall_patience
_MAX_RAY_DIST = C.PLANET_R * 10.0

# Cloud majorant-mip ladder (pathtracer.py:894-903).
_CLOUD_VALID = 8e3
_CLOUD_VALID_WIDE = 25e3
_CLOUD_VALID_COARSE = 115e3
_CLOUD_SKIP_FINE = 6e3
_CLOUD_SKIP_WIDE = 20e3
_CLOUD_SKIP_COARSE = 100e3
_CLOUD_SPLIT = 0.2


def _run_lanes(budget: int, stride: int, state: dict, ctx: dict, body):
    """Run ``body(i, state, ctx) -> state`` over the lanes whose
    ``state["done"]`` is False, i = 0, stride, 2*stride, ... < budget."""
    i = 0
    while i < budget:
        live = torch.nonzero(~state["done"]).squeeze(1)
        if live.numel() == 0:
            break
        sub = body(
            i,
            {k: v[live] for k, v in state.items()},
            {k: v[live] for k, v in ctx.items()},
        )
        for k, v in sub.items():
            state[k][live] = v
        i += stride
    return state


def _first(stop_k):
    """Index of the first True probe along axis 0 (0 if none)."""
    return torch.argmax(stop_k.to(torch.int32), dim=0)


def _sel(a, first):
    """a[first[n], n, ...] for a (k, n, ...) stack."""
    idx = first.view((1,) + first.shape + (1,) * (a.dim() - 2))
    idx = idx.expand((1,) + a.shape[1:])
    return torch.gather(a, 0, idx).squeeze(0)


def _cumsum(steps):
    """Sequential prefix sum over the probe axis (XLA's CPU order)."""
    out = [steps[0]]
    for j in range(1, steps.shape[0]):
        out.append(out[-1] + steps[j])
    return torch.stack(out)


def _march_floor(topo, cfg: TraceConfig):
    texel_arc = math.pi * C.PLANET_R / topo.shape[1]
    step_floor = texel_arc * cfg.march_floor_frac
    return step_floor, step_floor * 0.25


# ---------------------------------------------------------------------------
# Land march (pathtracer.py:211-579)
# ---------------------------------------------------------------------------


def intersect_land_plain(topo, pos, direction, scale, active, cfg: TraceConfig,
                         t_cap=None, any_hit=False):
    """Plain PyTorch twin of the ``land_march`` kernel: hit distance, -1 on
    a miss."""
    n = pos.shape[0]
    dev = pos.device
    k = cfg.march_k
    step_floor, stall_thresh = _march_floor(topo, cfg)
    if t_cap is None:
        t_cap = torch.full((n,), math.inf, device=dev)

    bound_near, bound_far = rsi(pos, direction, C.PLANET_R + scale)
    may_hit = active & (bound_far > 0.0)
    t0 = torch.clamp(bound_near, min=0.0)
    miss_beyond = torch.clamp(bound_far + 1.0, max=_MAX_RAY_DIST)
    miss_beyond = torch.minimum(miss_beyond, t_cap)
    may_hit = may_hit & (t0 < t_cap)

    arange_k = torch.arange(k, dtype=torch.float32, device=dev)[:, None]
    valid3 = torch.tensor(
        [_MIP_VALID_FINE, _MIP_VALID_COARSE, _CLOUD_VALID], device=dev
    )[:, None, None]

    def body(i, s, c):
        t, stride = s["t"], s["stride"]
        ts = t[None, :] + arange_k * stride[None, :]  # (k, m)
        ro = c["pos"][None] + ts[..., None] * c["dir"][None]
        sample = tx.sample_sphere_texture(topo, ro, bilinear=False)  # (k, m, 4)
        dir_b = c["dir"][None].expand_as(ro)
        b = dot(ro, dir_b)
        cr = cross(ro, dir_b)
        h2b = dot(cr, cr)
        rlen = torch.sqrt(dot(ro, ro))
        f = rlen - C.PLANET_R - scale * sample[..., 0]

        mips = sample[..., 1:4].movedim(-1, 0)  # (3, k, m)
        r_bound = C.PLANET_R + scale * mips
        disc = r_bound * r_bound - h2b[None]
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        miss3 = disc < 0.0
        near3 = torch.where(miss3, -1.0, -b[None] - sq)
        far3 = torch.where(miss3, -1.0, -b[None] + sq)
        s_region = torch.amax(
            torch.where(
                near3 > 0.0,
                torch.minimum(near3, valid3),
                torch.where(far3 < 0.0, valid3, 0.0),
            ),
            dim=0,
        )
        step = torch.where(
            f < 0.0, f,
            torch.clamp(torch.maximum(f, s_region), min=step_floor),
        )
        pdisc = C.PLANET_R * C.PLANET_R - h2b
        p_near = torch.where(
            pdisc < 0.0, -1.0, -b - torch.sqrt(torch.clamp(pdisc, min=0.0))
        )
        ocean_hit = torch.any(
            (mips <= 0.0) & (p_near[None] > 0.0) & (p_near[None] <= valid3),
            dim=0,
        )
        converged = torch.abs(f) < ts * 1e-4
        t_conv = torch.where(converged, ts, ts + p_near)
        converged = converged | ocean_hit
        if any_hit:
            converged = converged | (f < 0.0)
            t_conv = torch.where(f < 0.0, ts, t_conv)
        out = ts > c["miss_beyond"][None, :]
        stop_k = converged | out | (step < stride[None, :])
        any_stop = torch.any(stop_k, dim=0)
        first = _first(stop_k)

        t_stop = _sel(torch.where(converged, t_conv, ts), first)
        step_stop = _sel(step, first)
        conv_stop = _sel(converged, first)
        out_stop = _sel(out, first)
        t_stopped = torch.where(conv_stop | out_stop, t_stop, t_stop + step_stop)
        t_new = torch.where(any_stop, t_stopped, ts[-1] + step[-1])
        applied = torch.where(any_stop, step_stop, step[-1])
        stride_new = torch.clamp(applied, min=step_floor)

        newly_done = any_stop & (conv_stop | out_stop)
        missed = s["missed"] | (any_stop & out_stop & ~conv_stop)
        t_next = torch.where(newly_done, t_stop, t_new)
        stalled_now = (~newly_done) & (t_next - t < stall_thresh)
        stall = torch.where(stalled_now, s["stall"] + 1, 0)
        stuck = stall >= _MARCH_STALL_PATIENCE
        stride = torch.where(newly_done | stuck, stride, stride_new)
        return dict(t=t_next, stride=stride, done=newly_done | stuck,
                    missed=missed, stall=stall)

    state = dict(
        t=t0.clone(),
        stride=torch.full((n,), step_floor, device=dev),
        done=~may_hit,
        missed=~may_hit,
        stall=torch.zeros((n,), dtype=torch.int32, device=dev),
    )
    ctx = dict(pos=pos, dir=direction, miss_beyond=miss_beyond)
    state = _run_lanes(cfg.land_march_steps, k, state, ctx, body)
    t = state["t"]
    result = torch.where((~state["missed"]) & (t < _MAX_RAY_DIST), t, -1.0)
    return _phantom_crawl(pos, direction, active, result, t_cap, cfg)


def _phantom_crawl(pos, direction, active, result, t_cap, cfg: TraceConfig):
    """The reference march's budget-exhaustion 'phantom' hits for miss lanes
    whose line perigee lies below 16 km, emulated as a gather-free h = 0
    crawl (pathtracer.py:515-579)."""
    b0 = dot(pos, direction)
    cr = cross(pos, direction)
    h2 = dot(cr, cr)
    a_near, _ = rsi(pos, direction, C.ATMOS_UPPER_LIMIT)
    t0 = torch.where(a_near > 0.0, a_near, 0.0)
    perigee_alt = torch.sqrt(h2) - C.PLANET_R
    need = active & (result < 0.0) & (perigee_alt < _PHANTOM_PRUNE_ALT)

    def body(i, s, c):
        t, done = s["t"], s["done"]
        for _ in range(8):
            b = c["b0"] + t
            dist = torch.sqrt(c["h2"] + b * b) - C.PLANET_R
            t_new = t + dist
            stop = (t_new > _MAX_RAY_DIST) | (torch.abs(dist) < t_new * 1e-4)
            t = torch.where(done, t, t_new)
            done = done | stop
        return dict(t=t, done=done)

    state = _run_lanes(
        cfg.land_march_steps, 8, dict(t=t0.clone(), done=~need),
        dict(b0=b0, h2=h2), body,
    )
    t_ph = state["t"]
    phantom = need & (t_ph < _MAX_RAY_DIST) & (t_ph < t_cap)
    return torch.where(phantom, t_ph, result)


def intersect_land(topo, pos, direction, scale, active, cfg: TraceConfig,
                   t_cap=None, any_hit=False):
    """Land hit distance along each ray (-1 on a miss), with an optional
    per-lane ``t_cap`` (a volume event truncates the march) and an
    ``any_hit`` mode for shadow rays. CPU tensors: the plain version; CUDA
    tensors: the ``land_march`` kernel."""
    n = pos.shape[0]
    if pos.device.type == "cpu":
        return intersect_land_plain(
            topo, pos, direction, scale, active, cfg, t_cap, any_hit
        )
    if t_cap is None:
        t_cap = torch.full((n,), math.inf, device=pos.device)
    step_floor, stall_thresh = _march_floor(topo, cfg)
    return kernels.land_march(
        topo, pos, direction, active, t_cap, float(scale),
        step_floor=step_floor, stall_thresh=stall_thresh,
        steps=cfg.land_march_steps, k=cfg.march_k,
        patience=_MARCH_STALL_PATIENCE, any_hit=any_hit,
    )


# ---------------------------------------------------------------------------
# RMO delta tracking (pathtracer.py:631-746)
# ---------------------------------------------------------------------------

_ALBEDOS = torch.from_numpy(C.SCATTERING_ALBEDOS)


def delta_track_rmo_plain(keys, ray_pos, ray_dir, t_start, t_max, ext_h,
                          active, cfg: TraceConfig):
    """Plain PyTorch twin of the ``rmo_delta_track`` kernel. ``ext_h`` is
    the (n, 3) hero-wavelength extinction. Returns (event, t, iid)."""
    n = t_start.shape[0]
    dev = t_start.device
    k = cfg.tracking_k
    valid = active & (t_max >= 0.0) & (t_start < t_max)
    t_max_safe = torch.clamp(t_max, min=0.0)
    rp, xp = atm._ray_perigee(ray_pos, ray_dir)
    albedos = _ALBEDOS.to(dev)

    def body(i, s, c):
        t = s["t"]
        u = rng.uniform(rng.fold(c["keys"], i), (3, k))  # (3, k, m)
        r_min = atm.segment_min_radius(c["rp"], t + c["xp"], c["x_end"])
        env = atm.density_envelope(r_min - C.PLANET_R)
        inv_max = 1.0 / torch.clamp(dot(c["ext_h"], env), min=1e-20)
        steps = -torch.log(torch.clamp(u[0], min=1e-12)) * inv_max
        ts = t[None, :] + _cumsum(steps)
        pos = c["pos"][None] + torch.minimum(ts, c["tms"][None])[..., None] * c["dir"][None]
        dens = vol.get_density(vol.get_elevation(pos))  # (k, m, 3)
        total_h = dot(dens, c["ext_h"][None])
        over_k = ts >= c["t_max"][None]
        real_k = u[1] < total_h * inv_max[None]
        stop_k = over_k | real_k
        any_stop = torch.any(stop_k, dim=0)
        first = _first(stop_k)
        t_sel = torch.where(any_stop, _sel(ts, first), ts[-1])
        over = _sel(over_k, first)
        ext_stop = _sel(dens, first) * c["ext_h"]
        r = _sel(u[1], first) / inv_max
        c0 = ext_stop[:, 0]
        c01 = c0 + ext_stop[:, 1]
        iid_new = torch.where(
            r < c0, C.RAYLEIGH_ID, torch.where(r < c01, C.MIE_ID, C.OZONE_ID)
        )
        scatters = _sel(u[2], first) < albedos[iid_new]
        hit = any_stop & ~over
        event = torch.where(
            hit, torch.where(scatters, SCATTER_EVENT, ABSORB_EVENT), s["event"]
        ).to(torch.int32)
        iid = torch.where(hit, iid_new, s["iid"]).to(torch.int32)
        return dict(t=t_sel, done=any_stop, event=event, iid=iid)

    state = dict(
        t=t_start.clone(),
        done=~valid,
        event=torch.zeros((n,), dtype=torch.int32, device=dev),
        iid=torch.zeros((n,), dtype=torch.int32, device=dev),
    )
    ctx = dict(keys=keys, pos=ray_pos, dir=ray_dir, t_max=t_max, tms=t_max_safe,
               ext_h=ext_h, rp=rp, xp=xp, x_end=t_max_safe + xp)
    state = _run_lanes(cfg.max_tracking_steps, 1, state, ctx, body)
    return state["event"], state["t"], state["iid"]


def delta_track_rmo(keys, ray_pos, ray_dir, t_start, t_max, ext_h, active,
                    cfg: TraceConfig):
    """RMO free-flight event (event, t, interaction id) by delta tracking
    against the local hero majorant. CPU tensors: the plain version; CUDA
    tensors: the ``rmo_delta_track`` kernel."""
    if ray_pos.device.type == "cpu":
        return delta_track_rmo_plain(
            keys, ray_pos, ray_dir, t_start, t_max, ext_h, active, cfg
        )
    return kernels.rmo_delta_track(
        keys, ray_pos, ray_dir, t_start, t_max, ext_h, active,
        max_steps=cfg.max_tracking_steps, k=cfg.tracking_k,
        o3_env_peak=atm._O3_ENV_PEAK,
    )


# ---------------------------------------------------------------------------
# Cloud tracking (pathtracer.py:590-614, 906-1199)
# ---------------------------------------------------------------------------


def cloud_shape_density(cloud_texture, r):
    """Split-shape slab density from the column-height sample and radius."""
    in_slab = (r > C.CLOUDS_LOWER_LIMIT) & (r < C.CLOUDS_UPPER_LIMIT)
    h = (r - C.CLOUDS_LOWER_LIMIT) / C.CLOUDS_THICKNESS
    split = _CLOUD_SPLIT
    shape_on = (h - split < cloud_texture * (1.0 - split)) & (
        split - h < cloud_texture * split
    )
    density = torch.where(
        in_slab & shape_on, torch.clamp(cloud_texture, min=0.4), 0.0
    )
    return density * C.CLOUDS_DENSITY


def cloud_band_radii(mip):
    """Occupied radial band [r_lo, r_hi] implied by a regional max column
    height ``mip``."""
    lo = C.CLOUDS_LOWER_LIMIT + C.CLOUDS_THICKNESS * _CLOUD_SPLIT * (1.0 - mip)
    hi = C.CLOUDS_LOWER_LIMIT + C.CLOUDS_THICKNESS * (
        _CLOUD_SPLIT + mip * (1.0 - _CLOUD_SPLIT)
    )
    return lo, hi


def track_cloud_plain(keys, ray_pos, ray_dir, t_start, t_max, ext_w, clouds,
                      active, cfg: TraceConfig, mode: str):
    """Plain PyTorch twin of the ``cloud_track`` kernel: (event, t) in
    ``mode="delta"``, the (n,) transmittance in ``mode="ratio"``."""
    n = t_start.shape[0]
    dev = t_start.device
    k = cfg.tracking_k
    is_delta = mode == "delta"
    valid = active & (t_max >= 0.0) & (t_start < t_max)
    t_max_safe = torch.clamp(t_max, min=0.0)
    arange_k = torch.arange(k, device=dev)[:, None]
    cvalid3 = torch.tensor(
        [_CLOUD_VALID, _CLOUD_VALID_WIDE, _CLOUD_VALID_COARSE], device=dev
    )[:, None]

    def majorant(ext_w, mip_val):
        return torch.where(
            mip_val > 0.0,
            ext_w * C.CLOUDS_DENSITY * torch.clamp(mip_val, min=0.4),
            0.0,
        )

    def body(i, s, c):
        t, t_fetch, sig_loc, stride = s["t"], s["t_fetch"], s["sig"], s["stride"]
        ext_w, t_max, tms = c["ext_w"], c["t_max"], c["tms"]
        u = rng.uniform(rng.fold(c["keys"], i), (3, k))  # (3, k, m)

        skipping = sig_loc <= 0.0
        budget_end = torch.minimum(t_fetch + _CLOUD_VALID, t_max)
        skip_ts = t[None, :] + arange_k.to(torch.float32) * stride[None, :]
        steps = -torch.log(torch.clamp(u[0], min=1e-12)) / torch.clamp(
            sig_loc, min=1e-20
        )
        wood_ts = t[None, :] + _cumsum(steps)
        ts = torch.where(skipping[None, :], skip_ts, wood_ts)
        crossed = torch.where(
            skipping[None, :], ts >= t_max[None], ts >= budget_end[None, :]
        )
        ts_c = torch.minimum(
            ts,
            torch.where(
                skipping, tms, torch.minimum(budget_end, tms)
            )[None, :],
        )
        pos = c["pos"][None] + ts_c[..., None] * c["dir"][None]
        sample = tx.sample_sphere_texture(clouds, pos, bilinear=False)  # (k, m, 4)
        rlen = length(pos)
        fine_ext = ext_w[None, :] * cloud_shape_density(sample[..., 0], rlen)
        mips_k = sample[..., 1:4]  # (k, m, 3): tight, coarse, wide
        mip_f, mip_c, mip_w = mips_k[..., 0], mips_k[..., 1], mips_k[..., 2]

        # skip branch
        lvl_coarse = stride > _CLOUD_SKIP_WIDE * 1.5
        lvl_wide = (~lvl_coarse) & (stride > _CLOUD_SKIP_FINE * 1.5)
        probe_occ = torch.where(
            lvl_coarse[None, :],
            mip_c > 0.0,
            torch.where(lvl_wide[None, :], mip_w > 0.0, mip_f > 0.0),
        )
        skip_stop = probe_occ | crossed
        skip_any = torch.any(skip_stop, dim=0)
        skip_first = _first(skip_stop)
        skip_t = torch.where(skip_any, _sel(ts_c, skip_first), t + k * stride)
        skip_mips = torch.where(
            skip_any[:, None], _sel(mips_k, skip_first), mips_k[-1]
        )

        # tracking branch
        ratio = fine_ext / torch.clamp(sig_loc[None, :], min=1e-20)
        real_k = (u[1] < ratio) & (~crossed)
        stop_k = real_k | crossed
        any_stop = torch.any(stop_k, dim=0)
        first = _first(stop_k)
        if is_delta:
            wood_t = torch.where(any_stop, _sel(ts_c, first), ts_c[-1])
            wood_real = any_stop & _sel(real_k, first)
            wood_mips = torch.where(
                any_stop[:, None], _sel(mips_k, first), mips_k[-1]
            )
        else:
            any_crossed = torch.any(crossed, dim=0)
            first_cross = _first(crossed)
            wood_t = torch.where(any_crossed, _sel(ts_c, first_cross), ts_c[-1])
            wood_real = torch.zeros_like(any_crossed)
            wood_mips = torch.where(
                any_crossed[:, None], _sel(mips_k, first_cross), mips_k[-1]
            )
            factors = torch.where(crossed, 1.0, 1.0 - ratio)
            block = factors[0]
            for j in range(1, k):
                block = block * factors[j]

        step_lane = ~skipping
        skip_lane = skipping
        t_new = torch.where(skip_lane, skip_t, wood_t)
        new_mips = torch.where(skip_lane[:, None], skip_mips, wood_mips)
        new_mip_f, new_mip_c, new_mip_w = (
            new_mips[:, 0], new_mips[:, 1], new_mips[:, 2]
        )
        sig_new = majorant(ext_w, new_mip_f)
        stride_new = torch.where(
            new_mip_c <= 0.0,
            _CLOUD_SKIP_COARSE,
            torch.where(new_mip_w <= 0.0, _CLOUD_SKIP_WIDE, _CLOUD_SKIP_FINE),
        )
        t_fetch_new = t_new

        event, trans = s["event"], s["trans"]
        done = torch.zeros_like(skipping)
        if is_delta:
            hit = step_lane & wood_real
            scatters = _sel(u[2], first) < C.CLOUD_ALBEDO
            event = torch.where(
                hit, torch.where(scatters, SCATTER_EVENT, ABSORB_EVENT), event
            ).to(torch.int32)
            done = done | hit
        else:
            trans = torch.where(step_lane, trans * block, trans)
            t_rr = 0.05
            p_cont = torch.clamp(trans / t_rr, 0.0, 1.0)
            rr_active = step_lane & (p_cont < 1.0)
            killed = rr_active & (u[2, 0] >= p_cont)
            boosted = rr_active & ~killed
            trans = torch.where(
                killed, 0.0, trans / torch.where(boosted, p_cont, 1.0)
            )
            done = done | killed | (trans < 1e-5)

        # analytic radial-band skip from the stop tap
        at_tap = (~skip_lane) | skip_any
        jmask = (~done) & at_tap
        pos_stop = c["pos"] + t_new[:, None] * c["dir"]
        b_stop = dot(pos_stop, c["dir"])
        crs = cross(pos_stop, c["dir"])
        h2s = dot(crs, crs)
        r_stop = length(pos_stop)
        mips3 = torch.stack([new_mip_f, new_mip_w, new_mip_c])  # (3, m)
        lo3, hi3 = cloud_band_radii(mips3)
        beps = 4.0
        above3 = r_stop[None] > hi3 + beps
        below3 = r_stop[None] < lo3 - beps
        dh = hi3 * hi3 - h2s[None]
        hi_near = torch.where(
            dh < 0.0, -1.0, -b_stop[None] - torch.sqrt(torch.clamp(dh, min=0.0))
        )
        dl = lo3 * lo3 - h2s[None]
        lo_far = torch.where(
            dl < 0.0, -1.0, -b_stop[None] + torch.sqrt(torch.clamp(dl, min=0.0))
        )
        t_ent3 = torch.where(
            above3,
            torch.where(hi_near > 0.0, hi_near, 3e7),
            torch.where(below3, torch.clamp(lo_far, min=0.0), 0.0),
        )
        jump = torch.amax(torch.minimum(t_ent3, cvalid3), dim=0)
        jump = torch.where(jmask, jump, 0.0)
        t_new = t_new + jump
        jumped = jump > 0.0
        sig_new = torch.where(jumped, 0.0, sig_new)
        t_fetch_new = torch.where(jumped, t_new, t_fetch_new)
        done = done | (t_new >= t_max)
        return dict(t=t_new, done=done, t_fetch=t_fetch_new, sig=sig_new,
                    stride=stride_new, event=event, trans=trans)

    state = dict(
        t=t_start.clone(),
        done=~valid,
        t_fetch=t_start.clone(),
        sig=torch.zeros((n,), device=dev),
        stride=torch.full((n,), _CLOUD_SKIP_FINE, device=dev),
        event=torch.zeros((n,), dtype=torch.int32, device=dev),
        trans=torch.ones((n,), device=dev),
    )
    ctx = dict(keys=keys, pos=ray_pos, dir=ray_dir, t_max=t_max, tms=t_max_safe,
               ext_w=ext_w)
    state = _run_lanes(cfg.max_tracking_steps, 1, state, ctx, body)
    if is_delta:
        return state["event"], state["t"]
    return state["trans"]


def track_cloud(keys, ray_pos, ray_dir, t_start, t_max, ext_w, clouds, active,
                cfg: TraceConfig, mode: str):
    """Space-skipping cloud tracking: (event, t) for ``mode="delta"``, the
    transmittance for ``mode="ratio"``. CPU tensors: the plain version;
    CUDA tensors: the ``cloud_track`` kernel."""
    if mode not in ("delta", "ratio"):
        raise ValueError(f"unknown cloud tracking mode {mode!r}")
    if ray_pos.device.type == "cpu":
        return track_cloud_plain(
            keys, ray_pos, ray_dir, t_start, t_max, ext_w, clouds, active,
            cfg, mode,
        )
    return kernels.cloud_track(
        keys, ray_pos, ray_dir, t_start, t_max, ext_w, active, clouds,
        max_steps=cfg.max_tracking_steps, k=cfg.tracking_k,
        ratio=mode == "ratio",
    )
