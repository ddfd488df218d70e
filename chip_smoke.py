#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. It imports nothing of JAX or of the JAX package
``digital_earth_tpu`` (checked at the end). Phases, each of which raises on
failure (exit code 1):

1. toolchain: torch, CUDA, nvcc, Triton versions and the card
   (``nvidia-smi --query-gpu=name,power.limit``);
2. builds the kernels of ``digital_earth_tpu_torch/csrc`` with nvcc for
   sm_90a (timed);
3. holds the threefry header bit for bit against the plain ``uniform``;
4. renders one spp of the main path's frame (Apollo 11, 1920x1080, default
   ``TraceConfig()``) and keeps, per kernel call kind, the arguments the
   bounce gave the kernel wrapper at bounce 0 and at bounce DEEP_BOUNCE;
5. checks the port against the committed 32x18 golden render on the card;
6. the main path: ``render_offline`` of "scenes/config - Apollo 11.txt" at
   1920x1080, default ``TraceConfig()``, procedural 1024x2048 atlas, 1
   warm-up + 2 timed spp, with every kernel's launch count > 0 and a finite
   buffer of positive mean;
7. holds each kernel against its plain PyTorch twin on the arguments kept in
   phase 4, lane by lane, and times both.

The viewer's path (each run with the launch counts set to 0 just before it
and read just after):

8.  ``gen_rays`` against its plain twin on the 1920x1080 path-mode and the
    480x270 preview-mode inputs: lane keys bit-equal, the rest within the
    stated bounds;
9.  ``film_postprocess`` (Triton) against its twin on the phase-6 buffer,
    OpenDRT and AgX, a scalar spp and a per-pixel count;
10. the preview frame: Apollo 11 at 480x270 (the viewer's preview of a
    1920x1080 view), ``accumulate`` + ``fetch_image``, with ``atmos_march``
    and ``land_march`` launched; ``atmos_march`` against its twin on the
    arguments of bounces 0 and 1, lane by lane; the committed preview
    golden (32x18) on the card;
11. ``accumulate_interruptible(9)`` at 1920x1080 bit-equal to
    ``accumulate()`` for the same seed and round;
12. ``EarthViewer`` at 1920x1080 on an ephemeral port, driven over HTTP:
    a preview frame, then a path frame with spp >= 1, a new preview frame
    after ``/input?keys=w`` sent in the middle of a path spp (which polls
    for input between bounces; latency printed), then with 3 chunks per
    spp a path frame again, ``/frame.png`` a 1920x1080 PNG.

The line before the last is the card's name and power limit; before it, one
JSON line lists each kernel with its launches, error and times. The last
line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "config - Apollo 11.txt")
RES = (1920, 1080)
DEEP_BOUNCE = 3

# Stated tolerances, kernel vs plain twin on the same inputs on the card.
# Both round op by op with the same CUDA libm, so a lane disagrees only
# where a probe or an event sits within an ulp of its threshold.
MIN_LANE_AGREEMENT = 1.0 - 1e-5  # share of lanes with the same outcome and value
T_RTOL = 1e-4                    # hit / event distance, relative (floor 1 m)
RATIO_RTOL, RATIO_ATOL = 1e-4, 1e-6  # ratio-tracking transmittance
# gen_rays: the twin's CUDA ops divide by a scalar as a multiply by its
# reciprocal, the kernel divides, so directions and wavelengths move by an ulp.
DIR_ATOL, WL_RTOL, RESP_ATOL, PDF_RTOL = 1e-6, 1e-6, 1e-4, 1e-4
MARCH_RTOL = 1e-4   # atmos_march in-scatter / transmittance (atol 1e-6 of the max)
FILM_ATOL = 1e-4    # film_postprocess display values in [0, 1]
PREVIEW_RES = (480, 270)  # the viewer's preview (preview_scale=4) of RES
MAIN_PATH = ("land_march", "rmo_delta_track", "cloud_track", "gen_rays", "film_postprocess")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def toolchain(torch):
    from digital_earth_tpu_torch import kernels

    nvcc = kernels.nvcc_path()
    nv = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    nv_line = [l for l in nv.stdout.splitlines() if "release" in l]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  triton {triton_v}")
    print(f"nvcc: {nv_line[0].strip() if nv_line else nv.stdout.strip()}")
    print(f"card: {nvidia_smi_line()}")


def check_threefry(torch, dev):
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import rng

    keys = rng.lane_keys(rng.prng_key(7, dev), torch.arange(1 << 16, device=dev) * 7919)
    for data in (0, 5, 0xFFFFFFFF):
        got = kernels.threefry_uniform(keys, data, 12)
        want = rng.uniform(rng.fold(keys, data), (12,))
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"threefry header disagrees with ops/rng.uniform (data={data})")
    print("threefry: kernel header bit-equal to ops/rng.uniform on 65536 lanes x 12 draws x 3 folds")


def capture_inputs(torch, dev, atlas, luts):
    """One spp of the main path's frame with the kernels; keeps, per kernel
    call kind and bounce (0 and DEEP_BOUNCE), a copy of the arguments of the
    call with the most active lanes."""
    from digital_earth_tpu_torch.app.config_io import apply_config, load_config
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render.renderer import Renderer

    captured = {}
    state = {"bounce": None}
    originals = {name: getattr(pt, name) for name in
                 ("intersect_land", "delta_track_rmo", "track_cloud", "run_bounce")}

    def keep(kind, args, kwargs, active):
        b = state["bounce"]
        if b not in (0, DEEP_BOUNCE):
            return
        key = (kind, b)
        n_act = int(active.sum())
        if key not in captured or n_act > captured[key][0]:
            copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
            captured[key] = (n_act, tuple(map(copy, args)),
                             {k: copy(v) for k, v in kwargs.items()})

    def land(*args, **kwargs):
        kind = "land_march/any_hit" if kwargs.get("any_hit") else "land_march"
        keep(kind, args, kwargs, args[4])
        return originals["intersect_land"](*args, **kwargs)

    def rmo(*args, **kwargs):
        keep("rmo_delta_track", args, kwargs, args[6])
        return originals["delta_track_rmo"](*args, **kwargs)

    def cloud(*args, **kwargs):
        keep(f"cloud_track/{kwargs['mode']}", args, kwargs, args[7])
        return originals["track_cloud"](*args, **kwargs)

    def bounce(st, b, *args, **kwargs):
        state["bounce"] = b
        return originals["run_bounce"](st, b, *args, **kwargs)

    pt.intersect_land, pt.delta_track_rmo, pt.track_cloud, pt.run_bounce = (
        land, rmo, cloud, bounce)
    try:
        r = Renderer(dev, image_res=RES, atlas=atlas, luts=luts)
        apply_config(r, load_config(SCENE))
        r.accumulate()
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(pt, name, fn)
    kinds = sorted({kind for kind, _ in captured})
    print(f"captured kernel arguments at {RES[0]}x{RES[1]}: "
          + ", ".join(f"{k}@{b} ({captured[(k, b)][0]} active)" for k, b in sorted(captured)))
    if {k.split("/")[0] for k in kinds} != {"land_march", "rmo_delta_track", "cloud_track"}:
        fail(f"the capture frame did not reach every kernel: {kinds}")
    return captured


def _t_close(torch, a, b):
    return (a - b).abs() <= T_RTOL * torch.clamp(b.abs(), min=1e4)


def compare_kernels(torch, captured):
    """Each kernel against its plain twin on the captured inputs, lane by
    lane: (rows for the JSON line, True if all agree)."""
    from digital_earth_tpu_torch.render import tracers

    rows = {}
    for (kind, b), (n_act, args, kwargs) in sorted(captured.items()):
        base = kind.split("/")[0]
        kern_fn, plain_fn = {
            "land_march": (tracers.intersect_land, tracers.intersect_land_plain),
            "rmo_delta_track": (tracers.delta_track_rmo, tracers.delta_track_rmo_plain),
            "cloud_track": (tracers.track_cloud, tracers.track_cloud_plain),
        }[base]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p_out = plain_fn(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        k_out = kern_fn(*args, **kwargs)
        start.record()
        for _ in range(5):
            kern_fn(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5

        if base == "land_march":
            kh, ph = k_out >= 0, p_out >= 0
            same = kh == ph
            both = kh & ph
            lane_ok = same & (~both | _t_close(torch, k_out, p_out))
            err = (k_out - p_out).abs()[both]
            rel = err / p_out[both].clamp(min=1e4)
            what = f"hit/miss equal {same.float().mean().item():.7f}"
        elif kind == "cloud_track/ratio":
            diff = (k_out - p_out).abs()
            lane_ok = diff <= RATIO_ATOL + RATIO_RTOL * p_out.abs()
            err = diff
            rel = diff / p_out.abs().clamp(min=RATIO_ATOL)
            what = f"mean trans {k_out.mean().item():.6f} vs {p_out.mean().item():.6f}"
        else:
            same = k_out[0] == p_out[0]
            if base == "rmo_delta_track":
                same = same & (k_out[2] == p_out[2])  # species
            ev = same & (p_out[0] > 0)
            lane_ok = same & (~ev | _t_close(torch, k_out[1], p_out[1]))
            err = (k_out[1] - p_out[1]).abs()[ev]
            rel = err / p_out[1][ev].abs().clamp(min=1e4)
            what = f"event equal {same.float().mean().item():.7f}"
        n = lane_ok.numel()
        agree = lane_ok.float().mean().item()
        max_abs = err.max().item() if err.numel() else 0.0
        max_rel = rel.max().item() if rel.numel() else 0.0
        ok = agree >= MIN_LANE_AGREEMENT
        print(f"{kind:20s} bounce {b}: {n} lanes ({n_act} active)  {what}  "
              f"lanes agreeing {agree:.7f} ({n - int(lane_ok.sum())} not)  "
              f"max abs err {max_abs:.3e}  max rel err {max_rel:.3e}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.1f} ms  {'ok' if ok else 'FAIL'}")
        row = rows.setdefault(base, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, ok=True))
        row["max_abs_err"] = max(row["max_abs_err"], max_abs)
        row["ok"] = row["ok"] and ok
        if b == 0:  # the bounce-0 wavefront carries most of the frame's work
            row["ms"] += ms
            row["plain_ms"] += plain_ms
    return rows


def check_golden(torch, dev):
    """The 32x18 golden configuration on the card against the committed
    reference render (tests/golden, 2 spp)."""
    import numpy as np

    from digital_earth_tpu_torch.app.config_io import apply_config, load_config
    from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
    from digital_earth_tpu_torch.assets.textures import build_atlas
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    golden = np.load(os.path.join(ROOT, "tests", "golden", "apollo_path.npz"))
    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), dev)
    cfg = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256)
    r = Renderer(dev, image_res=(32, 18), atlas=atlas, seed=0, cfg=cfg)
    apply_config(r, load_config(SCENE))
    for _ in range(int(golden["spp"])):
        r.accumulate()
    buf = r.color_buffer.cpu().numpy()
    ref = golden["color_buffer"]
    share = np.isclose(buf, ref, rtol=1e-3, atol=1e-7).all(-1).mean()
    mean_rel = np.abs(buf.mean((0, 1)) / ref.mean((0, 1)) - 1.0).max()
    print(f"golden apollo 32x18 on the card: {share:.4f} of pixels within rtol 1e-3, "
          f"channel means within {mean_rel:.4f}")
    # The share floor of tests/test_torch_render.py. The card's libm rounds
    # differently again from both CPU backends, and one flipped bright path
    # moves a 576-pixel channel mean by about 2%: means within 5%.
    if not (share >= 0.92 and mean_rel <= 0.05):
        fail("the card's render disagrees with the committed reference golden")


def _time_ms(torch, fn, reps):
    """(result of a first call, mean ms of ``reps`` further calls), CUDA events."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _plain_ms(torch, fn):
    """(result, ms) of one warm call of a plain twin (after one call that
    pays PyTorch's first-use setup), CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _apollo(renderer):
    from digital_earth_tpu_torch.app.config_io import apply_config, load_config

    apply_config(renderer, load_config(SCENE))
    return renderer


def check_gen_rays(torch, dev, atlas, luts):
    """gen_rays against its twin on the path frame's 1920x1080 inputs and
    the 480x270 preview's: a row for the JSON line (the 1080p times)."""
    from digital_earth_tpu_torch.render import raygen
    from digital_earth_tpu_torch.render.renderer import Renderer

    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for mode, res in (("path", RES), ("preview", PREVIEW_RES)):
        r = _apollo(Renderer(dev, image_res=res, atlas=atlas, luts=luts, mode=mode))
        block = r.block if mode == "preview" else (1, res[1])
        args = (r._seed_key, 0, 0, res[0] * res[1], res, block, r.camera_params(), luts,
                mode == "preview")
        got, ms = _time_ms(torch, lambda: raygen.gen_rays(*args), 5)
        want, plain_ms = _plain_ms(torch, lambda: raygen.gen_rays_plain(*args))
        keys_equal = torch.equal(got.keys, want.keys)
        dir_err = (got.dirs - want.dirs).abs().max().item()
        wl_rel = ((got.wavelengths - want.wavelengths).abs() / want.wavelengths).max().item()
        resp_err = (got.responses - want.responses).abs().max().item()
        pdf_rel = ((got.pdf - want.pdf).abs() / want.pdf.abs().clamp(min=1e-6)).max().item()
        ok = (keys_equal and dir_err <= DIR_ATOL and wl_rel <= WL_RTOL
              and resp_err <= RESP_ATOL and pdf_rel <= PDF_RTOL)
        print(f"gen_rays {mode} {res[0]}x{res[1]} block {block}: keys bit-equal {keys_equal}, "
              f"dirs max abs err {dir_err:.3e}, wavelengths max rel err {wl_rel:.3e}, "
              f"responses max abs err {resp_err:.3e}, pdf max rel err {pdf_rel:.3e}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.1f} ms  {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"gen_rays disagrees with its plain twin in {mode} mode")
        row["max_abs_err"] = max(row["max_abs_err"], dir_err)
        if mode == "path":
            row["ms"], row["plain_ms"] = ms, plain_ms
    return row


def check_film(torch, buf, crf_curves):
    """film_postprocess against its twin on the 1080p main-path buffer."""
    from digital_earth_tpu_torch.render import film

    w, h = buf.shape[:2]
    counts = (torch.arange(w * h, device=buf.device) % 4 + 1).to(torch.float32).view(w, h, 1)
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for drt in ("opendrt", "agx"):
        for spp in (3.0, counts):
            args = (buf, spp, 2.432, 1.001, crf_curves, 12, drt)
            got, ms = _time_ms(torch, lambda: film.postprocess(*args), 5)
            want, plain_ms = _plain_ms(torch, lambda: film.postprocess_plain(*args))
            err = (got - want).abs().max().item()
            kind = "scalar spp" if isinstance(spp, float) else "per-pixel count"
            print(f"film_postprocess {drt} {kind} {w}x{h}: max abs err {err:.3e}  "
                  f"kernel {ms:.3f} ms  plain {plain_ms:.1f} ms  "
                  f"{'ok' if err <= FILM_ATOL else 'FAIL'}")
            if not err <= FILM_ATOL:
                fail(f"film_postprocess disagrees with its plain twin ({drt}, {kind})")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if drt == "opendrt" and kind == "scalar spp":
                row["ms"], row["plain_ms"] = ms, plain_ms
    return row


def preview_frame(torch, dev, atlas, luts):
    """The preview frame at 480x270: timed, its launches counted, and
    atmos_march held against its twin on the arguments of bounces 0 and 1.
    Returns (launch counts of one frame, JSON row)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raymarcher
    from digital_earth_tpu_torch.render.renderer import Renderer

    r = _apollo(Renderer(dev, image_res=PREVIEW_RES, atlas=atlas, luts=luts, mode="preview"))
    captured = []
    original = raymarcher.ray_march_atmos

    def keep(*args):
        if len(captured) < 2:
            captured.append(tuple(a.clone() for a in args))
        return original(*args)

    raymarcher.ray_march_atmos = keep
    try:
        r.accumulate()  # warm-up, and the capture of bounces 0 and 1
        r.fetch_image()
        torch.cuda.synchronize()
    finally:
        raymarcher.ray_march_atmos = original
    times = []
    for _ in range(3):
        r.reset_framebuffer()
        kernels.reset_launch_counts()
        t0 = time.time()
        r.accumulate()
        img = r.fetch_image()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        counts = kernels.launch_counts()
    finite = bool(torch.isfinite(img).all()) and bool(torch.isfinite(r.color_buffer).all())
    print(f"preview frame Apollo 11 {PREVIEW_RES[0]}x{PREVIEW_RES[1]} (accumulate + fetch_image, "
          f"warm): {' '.join(f'{t * 1e3:.1f}' for t in times)} ms; launches {counts}; "
          f"finite {finite}, buffer mean {r.color_buffer.mean().item():.6g}")
    if not (counts["atmos_march"] > 0 and counts["land_march"] > 0 and counts["gen_rays"] > 0
            and counts["film_postprocess"] > 0):
        fail(f"the preview frame did not launch its kernels: {counts}")
    if not (finite and r.color_buffer.mean().item() > 0.0):
        fail("the preview frame is not finite with a positive mean")

    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for b, args in enumerate(captured):
        active = args[-1]
        got, ms = _time_ms(torch, lambda: raymarcher.ray_march_atmos(*args), 5)
        want, plain_ms = _plain_ms(torch, lambda: raymarcher.ray_march_atmos_plain(*args))
        lane_ok = torch.ones_like(active)
        errs = []
        for g, w in zip(got, want):
            atol = 1e-6 * w[active].abs().max().clamp(min=1e-30)
            lane_ok &= (g - w).abs() <= MARCH_RTOL * w.abs() + atol
            errs.append((g - w)[active].abs().max().item())
        agree = lane_ok[active].float().mean().item()
        n_act = int(active.sum())
        ok = agree >= MIN_LANE_AGREEMENT
        print(f"atmos_march bounce {b}: {active.numel()} lanes ({n_act} active)  lanes agreeing "
              f"{agree:.7f} ({n_act - int(lane_ok[active].sum())} not)  max abs err "
              f"in-scatter {errs[0]:.3e} transmittance {errs[1]:.3e}  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.1f} ms  {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("atmos_march disagrees with its plain twin")
        row["max_abs_err"] = max(row["max_abs_err"], errs[0])
        if b == 0:
            row["ms"], row["plain_ms"] = ms, plain_ms
    return counts, row


def check_preview_golden(torch, dev):
    """The committed 32x18 preview golden on the card, with the CPU test's
    floors (tests/test_torch_preview.py)."""
    import numpy as np

    from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
    from digital_earth_tpu_torch.assets.textures import build_atlas
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    golden = np.load(os.path.join(ROOT, "tests", "golden", "apollo_preview.npz"))
    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), dev)
    cfg = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256)
    r = _apollo(Renderer(dev, image_res=(32, 18), atlas=atlas, tile_pixels=576, seed=0,
                         cfg=cfg, mode="preview"))
    for _ in range(int(golden["spp"])):
        r.accumulate()
    buf, ref = r.color_buffer.cpu().numpy(), golden["color_buffer"]
    share = np.isclose(buf, ref, rtol=1e-3, atol=1e-7).all(-1).mean()
    mean_rel = np.abs(buf.mean((0, 1)) / ref.mean((0, 1)) - 1.0).max()
    print(f"golden apollo preview 32x18 on the card: {share:.4f} of pixels within rtol 1e-3, "
          f"channel means within {mean_rel:.2e}")
    if not (share >= 0.99 and mean_rel <= 1e-3):
        fail("the card's preview disagrees with the committed preview golden")


def check_chunked(torch, dev, atlas, luts):
    """accumulate_interruptible(9) at 1920x1080 against accumulate(), same
    seed and round: bit-equal. Returns (whole s, chunked s)."""
    from digital_earth_tpu_torch.render.renderer import Renderer

    a = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts, seed=5))
    b = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts, seed=5))
    torch.cuda.synchronize()
    t0 = time.time()
    a.accumulate()
    torch.cuda.synchronize()
    t_whole = time.time() - t0
    polls = []
    t0 = time.time()
    done = b.accumulate_interruptible(9, interrupt=lambda: polls.append(1) or False)
    torch.cuda.synchronize()
    t_chunked = time.time() - t0
    equal = torch.equal(a.color_buffer, b.color_buffer)
    print(f"chunked spp {RES[0]}x{RES[1]}: accumulate {t_whole:.3f} s, "
          f"accumulate_interruptible(9) {t_chunked:.3f} s ({len(polls)} polls: 8 between "
          f"chunks, the rest between bounces), bit-equal {equal}")
    # at least one bounce poll in each of the 9 chunks
    if not (done and equal and len(polls) >= 8 + 9):
        fail("the chunked spp is not bit-equal to the whole spp")
    return t_whole, t_chunked


def check_viewer(torch, dev, atlas, luts):
    """EarthViewer at 1920x1080 driven over HTTP on an ephemeral port.
    Returns the launch counts of the whole viewer run."""
    import shutil
    import struct
    import threading
    import urllib.request

    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.viewer import EarthViewer

    work = os.path.join(ROOT, "build", "chip_smoke", "viewer")
    os.makedirs(work, exist_ok=True)
    config = os.path.join(work, "config.txt")
    shutil.copy(SCENE, config)
    kernels.reset_launch_counts()
    t_start = time.time()
    v = EarthViewer(device=dev, image_res=RES, config_path=config,
                    screenshot_dir=os.path.join(work, "shots"), port=0, atlas=atlas, luts=luts)
    v._running = True
    loop = threading.Thread(target=v._render_loop, daemon=True)
    loop.start()
    server = v.make_server(host="127.0.0.1", port=0)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as resp:
            return resp.read()

    def wait_for(pred, limit):
        deadline = time.time() + limit
        while time.time() < deadline:
            s = json.loads(get("/state"))
            if s["error"]:
                fail(f"the viewer's render loop failed: {s['error']}")
            if pred(s):
                return s
            time.sleep(0.01)
        fail(f"the viewer did not reach the expected state within {limit} s: {s}")

    try:
        s = wait_for(lambda s: s["frames"] >= 1 and s["frame_source"] == "preview", 120)
        t_first = time.time() - t_start
        s = wait_for(lambda s: s["frame_source"] == "path" and s["spp"] >= 1, 120)
        t_path = time.time() - t_start
        time.sleep(0.5)  # into the next spp, which runs as one chunk
        frames = s["frames"]
        v.spp_chunks = 3  # read when the spp after the input starts
        t0 = time.time()
        get("/input?keys=w")
        s = wait_for(lambda s: s["frame_source"] == "preview" and s["frames"] > frames, 60)
        latency = time.time() - t0
        preview_s = s["frame_time"]
        t0 = time.time()
        s = wait_for(lambda s: s["frame_source"] == "path" and s["spp"] >= 1, 120)
        t_chunked = time.time() - t0
        state_t0 = time.time()
        get("/state")
        state_s = time.time() - state_t0
        png = get("/frame.png")
        w, h = struct.unpack(">II", png[16:24])
        print(f"viewer {RES[0]}x{RES[1]}: first preview frame after {t_first:.2f} s, first "
              f"path spp after {t_path:.2f} s; input -> new preview frame "
              f"{latency * 1e3:.1f} ms (preview frame_time {preview_s} s); then a 3-chunk "
              f"path spp {t_chunked:.2f} s after the preview; "
              f"/state answered in {state_s * 1e3:.1f} ms; /frame.png {len(png)} bytes {w}x{h}")
        if not (png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR" and (w, h) == RES):
            fail("/frame.png is not a 1920x1080 PNG")
    finally:
        v._running = False
        server.shutdown()
        server.server_close()
        loop.join(timeout=120)
    if loop.is_alive():
        fail("the viewer's render loop did not stop")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"launches in the viewer run: {counts}")
    if not all(v > 0 for v in counts.values()):
        fail(f"a kernel of the viewer's path never launched: {counts}")
    return counts


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "digital_earth_tpu_torch")):
        fail("run from a checkout: digital_earth_tpu_torch/ is missing beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda:0")

    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.textures import procedural_texture_atlas

    toolchain(torch)

    t0 = time.time()
    kernels.library()
    print(f"kernel build: {time.time() - t0:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})")

    check_threefry(torch, dev)

    t0 = time.time()
    atlas = procedural_texture_atlas(dev, (1024, 2048), seed=7)
    print(f"procedural 1024x2048 atlas: {time.time() - t0:.1f} s")
    luts = load_spectral_luts(dev)
    captured = capture_inputs(torch, dev, atlas, luts)

    check_golden(torch, dev)

    check_preview_golden(torch, dev)

    # --- the main path ---------------------------------------------------
    from digital_earth_tpu_torch.app.viewer import encode_png

    w, h = RES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    r = render_offline(load_config(SCENE), dev, spp=1, image_res=RES,
                       out_path=None, atlas=atlas, luts=luts)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    t0 = time.time()
    for _ in range(2):
        r.accumulate()
    torch.cuda.synchronize()
    dt = (time.time() - t0) / 2
    img = r.fetch_image()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    buf = r.color_buffer
    finite = bool(torch.isfinite(buf).all())
    mean = buf.mean().item()
    print(f"render_offline Apollo 11 {w}x{h}, default TraceConfig, 3 spp: "
          f"warm-up {warmup_s:.2f} s, {dt:.3f} s/spp, {w * h / dt:.1f} paths/s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches on the main path: {counts}; buffer finite {finite}, mean {mean:.6g}")
    if not all(counts[k] > 0 for k in MAIN_PATH):
        fail(f"a kernel of the main path never launched: {counts}")
    if not (finite and mean > 0.0):
        fail("the accumulated buffer is not finite with a positive mean")
    if not (bool(torch.isfinite(img).all()) and img.shape == (w, h, 3)):
        fail("fetch_image is not a finite (W, H, 3) image")
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "apollo11_1080p_3spp.png"), "wb") as f:
        f.write(encode_png(r.fetch_image_np()))

    rows = compare_kernels(torch, captured)
    bad = [name for name, row in rows.items() if not row["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # --- the viewer's path -------------------------------------------------
    rows["gen_rays"] = check_gen_rays(torch, dev, atlas, luts)
    rows["film_postprocess"] = check_film(torch, buf, r.crf.curves)
    del r, buf, img
    preview_counts, rows["atmos_march"] = preview_frame(torch, dev, atlas, luts)
    check_chunked(torch, dev, atlas, luts)
    check_viewer(torch, dev, atlas, luts)

    loaded = sorted(k for k in sys.modules
                    if k.split(".")[0] in ("jax", "jaxlib", "digital_earth_tpu"))
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded}")

    sources = {
        "land_march": ("cuda", "digital_earth_tpu_torch/csrc/land_march.cu",
                       "digital_earth_tpu/render/pathtracer.py:211"),
        "rmo_delta_track": ("cuda", "digital_earth_tpu_torch/csrc/rmo_delta_track.cu",
                            "digital_earth_tpu/render/pathtracer.py:631"),
        "cloud_track": ("cuda", "digital_earth_tpu_torch/csrc/cloud_track.cu",
                        "digital_earth_tpu/render/pathtracer.py:906"),
        "gen_rays": ("cuda", "digital_earth_tpu_torch/csrc/gen_rays.cu",
                     "digital_earth_tpu/render/renderer.py:160"),
        "atmos_march": ("cuda", "digital_earth_tpu_torch/csrc/atmos_march.cu",
                        "digital_earth_tpu/render/raymarcher.py:56"),
        "film_postprocess": ("triton", "digital_earth_tpu_torch/csrc/film_postprocess.py",
                             "digital_earth_tpu/render/film.py:438"),
    }
    # launches: the main path's run, or for the preview's kernel the
    # preview frame's run
    launches = dict(counts, atmos_march=preview_counts["atmos_march"])
    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"]}
        for name, (route, src, rep) in sources.items()
    ]}
    print(json.dumps(line))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
