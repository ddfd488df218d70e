"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first CUDA use, into the
git-ignored ``build/kernels/<source hash>/`` directory, and loaded with
``ctypes``. Each launcher checks device, dtype, shape and contiguity, runs on
``torch.cuda.current_stream()``, raises if the C entry returns a non-zero
``cudaGetLastError()``, and adds one to its ``launches`` counter. Nothing
here imports or builds anything until a kernel is launched; there is no
fallback to the plain versions.

Built with ``--fmad=false`` and without fast math, so the kernels round each
operation as PyTorch's element-wise CUDA ops do (the one fused multiply-add,
in the perigee radius, is ``fmaf`` here and a float64 multiply-add in the
plain version): a kernel and
its plain twin agree on the card up to libm-level differences, which matters
because a march hit or a tracking event near its threshold flips on one ulp.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_ROOT, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_ROOT), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
build_seconds = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # topo, H, W, pos, dir, active, t_cap, out, n, scale, step_floor,
    # stall_thresh, steps, k, patience, any_hit, stream
    "de_land_march": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _F, _F, _F,
                      _I, _I, _I, _I, _P],
    # keys, pos, dir, t_start, t_max, ext_h, active, event, t, iid, n,
    # max_steps, k, o3_env_peak, stream
    "de_rmo_delta_track": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _F, _P],
    # keys, pos, dir, t_start, t_max, ext_w, active, clouds, H, W, event, t,
    # trans, n, max_steps, k, ratio, stream
    "de_cloud_track": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                       _I, _I, _I, _I, _P],
    # keys, n, data, count, out, stream
    "de_threefry_uniform": [_P, _I, ctypes.c_uint, _I, _P, _P],
}


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def library():
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    srcs = _sources()
    digest = hashlib.sha256()
    for path in srcs:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = os.path.join(BUILD_ROOT, digest.hexdigest()[:16])
    so = os.path.join(out_dir, "libde_kernels.so")
    t0 = time.time()
    if not os.path.exists(so):
        nvcc = nvcc_path()
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               *[s for s in srcs if s.endswith(".cu")]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_seconds = time.time() - t0
    _lib = lib
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(fn_name, *args):
    rc = getattr(library(), fn_name)(
        *args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    )
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")


def keys_i32(keys):
    """(n, 2) int64 keys holding uint32 values -> the same bits as int32."""
    return torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32).contiguous()


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def land_march(topo, pos, direction, active, t_cap, scale: float, *,
               step_floor: float, stall_thresh: float, steps: int, k: int,
               patience: int, any_hit: bool):
    """Launch ``land_march`` (csrc/land_march.cu): (n,) hit distance, -1 on
    a miss."""
    dev = pos.device
    n = pos.shape[0]
    h, w = topo.shape[:2]
    _check("topo", topo, torch.uint8, (h, w, 4), dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("active", active, torch.bool, (n,), dev)
    _check("t_cap", t_cap, torch.float32, (n,), dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        _launch(
            "de_land_march", _ptr(topo), h, w, _ptr(pos), _ptr(direction),
            _ptr(active), _ptr(t_cap), _ptr(out), n, scale, step_floor,
            stall_thresh, steps, k, patience, int(any_hit),
        )
        land_march.launches += 1
    return out


def rmo_delta_track(keys, pos, direction, t_start, t_max, ext_h, active, *,
                    max_steps: int, k: int, o3_env_peak: float):
    """Launch ``rmo_delta_track`` (csrc/rmo_delta_track.cu):
    (event int32, t, iid int32)."""
    dev = pos.device
    n = pos.shape[0]
    keys = keys_i32(keys)
    _check("keys", keys, torch.int32, (n, 2), dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("t_start", t_start, torch.float32, (n,), dev)
    _check("t_max", t_max, torch.float32, (n,), dev)
    _check("ext_h", ext_h, torch.float32, (n, 3), dev)
    _check("active", active, torch.bool, (n,), dev)
    event = torch.empty((n,), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    iid = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        _launch(
            "de_rmo_delta_track", _ptr(keys), _ptr(pos), _ptr(direction),
            _ptr(t_start), _ptr(t_max), _ptr(ext_h), _ptr(active), _ptr(event),
            _ptr(t), _ptr(iid), n, max_steps, k, o3_env_peak,
        )
        rmo_delta_track.launches += 1
    return event, t, iid


def cloud_track(keys, pos, direction, t_start, t_max, ext_w, active, clouds, *,
                max_steps: int, k: int, ratio: bool):
    """Launch ``cloud_track`` (csrc/cloud_track.cu): (event int32, t) in
    delta mode, the (n,) transmittance in ratio mode."""
    dev = pos.device
    n = pos.shape[0]
    h, w = clouds.shape[:2]
    keys = keys_i32(keys)
    _check("keys", keys, torch.int32, (n, 2), dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("t_start", t_start, torch.float32, (n,), dev)
    _check("t_max", t_max, torch.float32, (n,), dev)
    _check("ext_w", ext_w, torch.float32, (n,), dev)
    _check("active", active, torch.bool, (n,), dev)
    _check("clouds", clouds, torch.uint8, (h, w, 4), dev)
    event = torch.empty((n,), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    trans = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        _launch(
            "de_cloud_track", _ptr(keys), _ptr(pos), _ptr(direction),
            _ptr(t_start), _ptr(t_max), _ptr(ext_w), _ptr(active),
            _ptr(clouds), h, w, _ptr(event), _ptr(t), _ptr(trans), n,
            max_steps, k, int(ratio),
        )
        cloud_track.launches += 1
    return trans if ratio else (event, t)


def threefry_uniform(keys, data: int, count: int):
    """Test launcher of the kernels' threefry header (not a path kernel):
    ``uniform(fold(keys, data), (count,))`` as (count, n), computed on the
    card by csrc/threefry_check.cu."""
    n = keys.shape[0]
    k32 = keys_i32(keys)
    out = torch.empty((count, n), dtype=torch.float32, device=keys.device)
    _launch("de_threefry_uniform", _ptr(k32), n, data & 0xFFFFFFFF, count, _ptr(out))
    return out


PATH_KERNELS = (land_march, rmo_delta_track, cloud_track)
for _k in PATH_KERNELS:
    _k.launches = 0


def reset_launch_counts():
    for fn in PATH_KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in PATH_KERNELS}
