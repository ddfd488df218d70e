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

    # --- the main path ---------------------------------------------------
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
    counts = kernels.launch_counts()
    buf = r.color_buffer
    finite = bool(torch.isfinite(buf).all())
    mean = buf.mean().item()
    img = r.fetch_image()
    print(f"render_offline Apollo 11 {w}x{h}, default TraceConfig, 3 spp: "
          f"warm-up {warmup_s:.2f} s, {dt:.3f} s/spp, {w * h / dt:.1f} paths/s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches on the main path: {counts}; buffer finite {finite}, mean {mean:.6g}")
    if not all(v > 0 for v in counts.values()):
        fail(f"a kernel of the main path never launched: {counts}")
    if not (finite and mean > 0.0):
        fail("the accumulated buffer is not finite with a positive mean")
    if not (bool(torch.isfinite(img).all()) and img.shape == (w, h, 3)):
        fail("fetch_image is not a finite (W, H, 3) image")
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    try:
        from PIL import Image
        Image.fromarray(r.fetch_image_np()).save(
            os.path.join(out_dir, "apollo11_1080p_3spp.png"))
    except ImportError:
        pass
    del r, buf, img

    rows = compare_kernels(torch, captured)
    bad = [name for name, row in rows.items() if not row["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    loaded = sorted(k for k in sys.modules
                    if k.split(".")[0] in ("jax", "jaxlib", "digital_earth_tpu"))
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded}")

    sources = {
        "land_march": ("digital_earth_tpu_torch/csrc/land_march.cu",
                       "digital_earth_tpu/render/pathtracer.py:211"),
        "rmo_delta_track": ("digital_earth_tpu_torch/csrc/rmo_delta_track.cu",
                            "digital_earth_tpu/render/pathtracer.py:631"),
        "cloud_track": ("digital_earth_tpu_torch/csrc/cloud_track.cu",
                        "digital_earth_tpu/render/pathtracer.py:906"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"]}
        for name, (src, rep) in sources.items()
    ]}
    print(json.dumps(line))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
