"""Build, bind and launch the hand-written kernels of ``csrc/``.

CUDA C++: each ``.cu`` source is compiled with ``nvcc`` for Hopper
(``sm_90a``) into an object, all sources at once in parallel, and the
objects are linked into one shared library with a plain C interface, at
first CUDA use, into the git-ignored ``build/kernels/<source hash>/``
directory, and loaded with ``ctypes``; ptxas's report of each source
(registers, spills) is kept in ``ptxas_log``. Each launcher checks device,
dtype, shape and contiguity (and a 4-channel texture's 4-byte alignment),
runs on ``torch.cuda.current_stream()`` of the calling thread's current
device (parallel/mesh.py's worker threads each set theirs),
raises if the launch fails (a non-zero ``cudaGetLastError()`` from a C
entry), and adds one to its ``launches`` counter (under a lock: a mesh
launches from several threads). Nothing here imports or builds anything
until a kernel is launched; there is no fallback to the plain versions.

The land march, the cloud tracker, the bounce entries and the preview each
have an options instance, built beside the default one (the bounce entries
also an estimator instance, below): it reads the scene
and march options (``render/params.SCENE_OPTIONS``) from its parameters at
run time, where the default instance compiles them in at their defaults
(every instance reads the stall patience at run time). A wrapper launches
the options instance when any flag it is given differs from its default, or
when its ``options`` keyword asks for it (a check that
it gives the default instance's bits at the defaults); such a launch also
adds one to the wrapper's ``options_launches``. The bounce entries' options
instances also run the reference-faithful naive arm (``BOUNCE_OPTIONS``'
``naive_*`` flags), whose loops have launchers of their own
(``naive_march``, ``naive_delta_track``, ``naive_ratio_track``). The
estimator options (``BOUNCE_ESTIMATOR_INTS`` and ``BOUNCE_ESTIMATOR_FLOATS``:
the analytic flight, whose launcher is ``flight_analytic``; the
counter-hash draws, whose launcher is ``fast_uniform_check``; the NEE and
cloud roulettes; no NEE) run in the bounce entries' estimator instances, a
set of their own that also takes the other options (counted as options
launches too). The march floors (the certified floor and a secondary
floor, ``BOUNCE_FLOOR_FLOATS``) run in a fourth set, the floor instances,
which also take the estimator options, and ``land_march`` and ``preview``
take the certified floor in a floor instance of their own (``cert_floor``);
each counted as an options launch. The tracker launchers ``rmo_delta_track``,
``rmo_ratio_track`` and ``cloud_track`` have instances that draw the
counter hash (``fast_rng``), counted as their options launches.

The main library holds the packets of ``BOUNCE_WIDTHS`` (1 and 4
wavelengths, TraceConfig.hero_lambdas). Every other width L runs from a
library of its own (``width_library``), built at its first use from the
same sources with ``-DDE_WIDTH=L`` (csrc/packet_width.cuh) into
``build/kernels/<hash of the sources and L>/``: the bounce entries as two
instance sets (csrc/width/), the default instances, which compile every
option in at its default, and the floor instances, which read every option
at run time; a launch at the default TraceConfig takes the default
instances, any option, estimator option or march floor off its default the
floor instances; then ``gen_rays``, ``rmo_ratio_track`` and, past
``FRAME_END_MAX_LAMBDAS``, ``frame_end``. A launch at such a width (of any
library) also adds one to the wrapper's count at that width,
``launch_counts``' ``"<name>/L<n>"``.

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
import math
import os
import shutil
import subprocess
import threading
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_ROOT, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_ROOT), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
_lock = threading.Lock()  # the builds, and the launch counters of worker threads
build_seconds = None
# ptxas's report (registers, spills) per source of the last build, by file name
ptxas_log = {}
# the width libraries (width_library) by packet width: the loaded library,
# and ptxas's report per source of the last build (by path under csrc/)
_width_libs = {}
width_ptxas_log = {}
# the measurement library (bench_library), loaded
_bench_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_BOUNCE_ARGS = [_P] * 15 + [_I, _I] + [_P] * 6
_SIGNATURES = {
    # topo, H, W, pos, dir, active, t_cap, out, n, scale, step_floor,
    # stall_thresh, steps, k, patience, any_hit, the options instance,
    # enable_land, bilinear, exact_ocean, ref_phantom, the certified floor,
    # the uncertified floor, stream
    "de_land_march": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _F, _F, _F,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # keys, pos, dir, t_start, t_max, ext_h, active, event, t, iid, n,
    # max_steps, k, o3_env_peak, fast (the options instance), stream
    "de_rmo_delta_track": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _F, _I, _P],
    # keys, pos, dir, t_start, t_max, ext, max_ext, active, trans, iters, n,
    # n_lambdas, max_steps, k, fast (the options instance), stream
    "de_rmo_ratio_track": [_P] * 10 + [_I, _I, _I, _I, _I, _P],
    # keys, pos, dir, t_start, t_max, ext_w, active, clouds, H, W, event, t,
    # trans, n, max_steps, k, ratio, the options instance, bilinear, fast,
    # stream
    "de_cloud_track": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P],
    # keys, pos, dir, t_start, t_max, ext_h, active, table, event, t, iid,
    # iters, n, n_iter, stream
    "de_flight_analytic": [_P] * 12 + [_I, _I, _P],
    # keys, n, counter, count, out, stream
    "de_fast_uniform": [_P, _I, ctypes.c_uint, _I, _P, _P],
    # topo, H, W, pos, dir, active, out, iters, n, scale, steps, enable_land,
    # bilinear, stream
    "de_naive_march": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _F, _I, _I, _I, _P],
    # keys, pos, dir, t_start, t_max, ext (n, 4), max_ext, active, clouds, H,
    # W, event, t, iid, trans, iters, n, max_steps, species (0 the gases, 1
    # the cloud), ratio, bilinear, stream
    "de_naive_track": [_P] * 9 + [_I, _I] + [_P] * 5 + [_I, _I, _I, _I, _I, _P],
    # pos, dir, t_start, t_max, sun_dir, ext_rmo, scattering, active,
    # in_scatter, trans, n, rayl_k, mie_e, two_pi, log_term, stream
    "de_atmos_march": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F,
                       _F, _P],
    # out (4 ints)
    "de_atmos_march_occupancy": [_P],
    # float params, int64 params, g, cie_response, keys, dirs, wavelengths,
    # responses, pdf, pid, tile_index, lane_index, tile_ids, n, stream
    "de_gen_rays": [_P] * 13 + [_I, _P],
    # float params, int params, radiance, responses, pdf, throughput, w_mis,
    # lambda_pdf, wavelength, direction, primary_miss, light_dir,
    # sun_cos_angle, stars, srgb2spec, pid, color, count, lum2, n, stream
    "de_frame_end": [_P] * 19 + [_I, _P],
    # float params, color, count, lum2, w, h, bw, bh, k, partial, m_bar,
    # score, counter, runs, ids, stream
    "de_select_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # float params, color, count, n_pix, partial, counter, mean, stream
    "de_shard_mean": [_P, _P, _P, _I, _P, _P, _P, _P],
    # float params, color, count, lum2, n_tiles, tile, k, m_bar, score,
    # counter, runs, ids, stream
    "de_select_tiles_shard": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # float params, int params, pos, dir, wavelength, lambda_pdf, throughput,
    # radiance, w_mis, alive, primary_miss, work_class, keys, idx, n_live, m,
    # n, topo, material, clouds, o3_crossec, srgb2spec, table; then scratch,
    # trips and cycles (de_bounce_flight, de_bounce_shade) or the stop bounce
    # (de_bounce_window); stream
    "de_bounce_flight": _BOUNCE_ARGS + [_P, _P, _P, _P],
    "de_bounce_shade": _BOUNCE_ARGS + [_P, _P, _P, _P],
    "de_bounce_window": _BOUNCE_ARGS + [_I, _P],
    # which, the options instance, out (4 ints)
    "de_bounce_occupancy": [_I, _I, _P],
    # alive, work_class, n, out, n_live, scratch, stream
    "de_compact_lanes": [_P, _P, _I, _P, _P, _P, _P],
    # n
    "de_compact_scratch_words": [_I],
    # u, trace, cbrt_f64, n, stream
    "de_draine_check": [_P, _P, _P, _I, _P],
    # pos, dir, t0, t1, ext_rmo, table, seg, trans, n, n_lambdas, stream
    "de_density_check": [_P] * 8 + [_I, _I, _P],
    # tex, H, W, C, pos, n, bilinear, out, stream
    "de_sphere_tap": [_P, _I, _I, _I, _P, _I, _I, _P, _P],
    # tex, H, W, C, dir, n, bilinear, out, stream
    "de_dir_tap": [_P, _I, _I, _I, _P, _I, _I, _P, _P],
    # keys, n, data, count, out, stream
    "de_threefry_uniform": [_P, _I, ctypes.c_uint, _I, _P, _P],
    # keys, n, data, depth, out, stream
    "de_threefry_fold": [_P, _I, ctypes.c_uint, _I, _P, _P],
    # keys, n, base, count, out, stream
    "de_threefry_draws": [_P, _I, ctypes.c_uint, _I, _P, _P],
    "de_threefry_draw_sum": [_P, _I, ctypes.c_uint, _I, _P, _P],
    # base, w, C, factor, out, n (64-bit), jitter channel, jitter, seed, stream
    "de_upsample": [_P, _I, _I, _I, _P, ctypes.c_int64, _I, _F, ctypes.c_uint, _P],
    # float params, int params, key k0, k1, origin, pos, dir, wavelength,
    # tile_index, lane_index, topo, material, stars, o3_crossec, srgb2spec,
    # out, cycles, n, stream
    "de_preview": [_P, _P, ctypes.c_uint, ctypes.c_uint] + [_P] * 13 + [_I, _P],
    # the options instance, out (4 ints)
    "de_preview_occupancy": [_I, _P],
    # float params, int params, color buffer, count, response table, out, stream
    "de_film_postprocess": [_P] * 7,
}
# the C entries of the measurement library (csrc/bench/): kernels that no
# render path launches
_BENCH_SIGNATURES = {
    # topo, H, W, pos, dir, active, out, iters, cycles, n, scale, steps,
    # bilinear, stream
    "de_naive_march_loop": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _P],
}


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


# the packet widths of the main library (csrc/packet_width.cuh); every other
# TraceConfig.hero_lambdas runs from its own width library
BOUNCE_WIDTHS = (1, 4)
# the widest packet the main library's frame_end takes (csrc/frame_end.cu
# MAX_LAMBDAS); a wider packet's frame_end runs from its width library
FRAME_END_MAX_LAMBDAS = 8
WIDTH_DIR = os.path.join(CSRC, "width")
BENCH_DIR = os.path.join(CSRC, "bench")
# the C entries of a width library: those of the sources of csrc/ it builds
# with -DDE_WIDTH=L (WIDTH_ENTRIES, and frame_end.cu past
# FRAME_END_MAX_LAMBDAS), the bounce entries' default and floor instances in
# WIDTH_DIR
WIDTH_ENTRIES = {"bounce.cu": ("de_bounce_flight", "de_bounce_shade", "de_bounce_window",
                               "de_bounce_occupancy"),
                 "gen_rays.cu": ("de_gen_rays",), "rmo_ratio_track.cu": ("de_rmo_ratio_track",)}


def _dir_sources(path):
    return sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".cu"))


def _width_dir_sources():
    return _dir_sources(WIDTH_DIR)


def _width_sources(L: int):
    entries = list(WIDTH_ENTRIES) + (["frame_end.cu"] if L > FRAME_END_MAX_LAMBDAS else [])
    return [os.path.join(CSRC, f) for f in entries] + _width_dir_sources()


def library():
    """The loaded kernel library, built on first call (by one thread)."""
    if _lib is not None:
        return _lib
    with _lock:
        return _lib if _lib is not None else _build()


def _library_dir(extra: str = "", more=None):
    """build/kernels/<hash of every source of csrc/ and of ``more`` (by
    default the width sources when ``extra``, the width's define, is given),
    the flags and ``extra``>."""
    digest = hashlib.sha256()
    more = (_width_dir_sources() if extra else []) if more is None else more
    for path in _sources() + more:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(extra.encode())
    return os.path.join(BUILD_ROOT, digest.hexdigest()[:16])


def _nvcc(builds):
    """Compile and link shared libraries with nvcc, every object of every
    library at once, in parallel: ``builds`` holds (library path, sources,
    extra flags, log), each source's ptxas report going into its log by its
    path under csrc/. Raises on the first failure."""
    nvcc = nvcc_path()
    tag = f"tmp{os.getpid()}"
    jobs = []
    for so, srcs, flags, log in builds:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        for src in srcs:
            obj = os.path.join(os.path.dirname(so), os.path.basename(src) + f".{tag}.o")
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj, src],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((so, src, obj, proc, log))
    try:
        for so, src, obj, proc, log in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{out}\n{err}")
            log[os.path.relpath(src, CSRC)] = out + err
    finally:
        for job in jobs:
            if job[3].poll() is None:
                job[3].kill()
                job[3].wait()
    for so, *_ in builds:
        objs = [obj for lib, _, obj, _, _ in jobs if lib == so]
        tmp = f"{so}.{tag}"
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        for obj in objs:
            os.remove(obj)


def _load(so, names, signatures=_SIGNATURES):
    lib = ctypes.CDLL(so)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = signatures[name]
        fn.restype = ctypes.c_int
    return lib


def _build():
    global _lib, build_seconds
    so = os.path.join(_library_dir(), "libde_kernels.so")
    t0 = time.time()
    if not os.path.exists(so):
        _nvcc([(so, [src for src in _sources() if src.endswith(".cu")], [], ptxas_log)])
    lib = _load(so, _SIGNATURES)
    build_seconds = time.time() - t0
    _lib = lib
    return lib


def _width_names(L: int):
    names = [name for entries in WIDTH_ENTRIES.values() for name in entries]
    return names + (["de_frame_end"] if L > FRAME_END_MAX_LAMBDAS else [])


def build_width_libraries(widths):
    """Build (or load, when built before) the width libraries of ``widths``
    (packet widths outside ``BOUNCE_WIDTHS``) in one parallel nvcc batch,
    each from the sources' ``-DDE_WIDTH=L`` build, and keep them loaded.
    Raises if a build fails."""
    widths = sorted(set(widths))
    for L in widths:
        if L in BOUNCE_WIDTHS or L < 1:
            raise ValueError(f"width library of {L} wavelengths: the main library holds "
                             f"{BOUNCE_WIDTHS}, a width library any other L >= 1")
    with _lock:
        todo = [L for L in widths if L not in _width_libs]
        sos = {L: os.path.join(_library_dir(f"-DDE_WIDTH={L}"), f"libde_width{L}.so") for L in todo}
        _nvcc([(sos[L], _width_sources(L), [f"-DDE_WIDTH={L}"], width_ptxas_log.setdefault(L, {}))
               for L in todo if not os.path.exists(sos[L])])
        for L in todo:
            _width_libs[L] = _load(sos[L], _width_names(L))


def bench_library():
    """The measurement library: the kernels of csrc/bench/, which no render
    path launches (chip_smoke.py times and disassembles them), built at its
    first use (by one thread) under a hash of its own."""
    global _bench_lib
    with _lock:
        if _bench_lib is None:
            srcs = _dir_sources(BENCH_DIR)
            so = os.path.join(_library_dir("bench", srcs), "libde_bench.so")
            if not os.path.exists(so):
                _nvcc([(so, srcs, [], {})])
            _bench_lib = _load(so, _BENCH_SIGNATURES, _BENCH_SIGNATURES)
        return _bench_lib


def width_library(L: int):
    """The loaded library of packet width ``L`` (outside ``BOUNCE_WIDTHS``),
    built at its first use (by one thread)."""
    lib = _width_libs.get(L)
    if lib is None:
        build_width_libraries([L])
        lib = _width_libs[L]
    return lib


def _library_of(width):
    """The library that holds a launch at packet ``width`` (None: the main)."""
    return library() if width is None or width in BOUNCE_WIDTHS else width_library(width)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_tex4(name, t, device):
    """A uint8 (H, W, 4) texture: the kernels read a texel as one 32-bit
    word (csrc/texture.cuh texel4), so its data must be 4-byte aligned."""
    _check(name, t, torch.uint8, (*t.shape[:2], 4), device)
    if t.data_ptr() % 4:
        raise ValueError(f"{name}: data not 4-byte aligned (the kernels read a 4-channel texel "
                         "as one 32-bit word)")


def _check_tex8(name, t, device):
    """A uint8 (H, W, 8) texture: the kernels' bilinear taps read a texel as
    one 64-bit word (csrc/texture.cuh texel8), so its data must be 8-byte
    aligned."""
    _check(name, t, torch.uint8, (*t.shape[:2], 8), device)
    if t.data_ptr() % 8:
        raise ValueError(f"{name}: data not 8-byte aligned (the kernels read an 8-channel texel "
                         "as one 64-bit word)")


def _launch(fn_name, *args, width=None):
    """Call the C entry ``fn_name`` of the library of packet ``width`` (None:
    the main library; the measurement library's entries from it) on the
    current stream; raises on a CUDA error."""
    lib = bench_library() if fn_name in _BENCH_SIGNATURES else _library_of(width)
    rc = getattr(lib, fn_name)(
        *args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    )
    if rc != 0:
        where = "" if width is None or width in BOUNCE_WIDTHS else f" (the L = {width} library)"
        raise RuntimeError(f"{fn_name}{where}: CUDA error {rc}")


def _count(fn, n, options=False, width=None):
    with _lock:
        fn.launches += n
        if options:
            fn.options_launches += n
        if width is not None and width not in BOUNCE_WIDTHS:
            fn.width_launches[width] = fn.width_launches.get(width, 0) + n


# The scene and march flags' defaults (render/params.SCENE_OPTIONS), at
# which the default instances are built, and the march's flags in the order
# the march launcher and the preview's int block take them (the stall
# patience is a run-time parameter of every instance)
OPTION_DEFAULTS = dict(enable_clouds=1, enable_land=1, bilinear_tracking=0, lazy_march=1,
                       march_exact_ocean=1, march_ref_phantom=1, naive_tracking=0, naive_march=0,
                       naive_cloud_tracking=0, naive_shadow=0)
MARCH_OPTIONS = ("enable_land", "bilinear_tracking", "march_exact_ocean", "march_ref_phantom")


def keys_i32(keys):
    """(n, 2) int64 keys holding uint32 values -> the same bits as int32."""
    return torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32).contiguous()


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _ptr_or_null(t):
    return None if t is None else _ptr(t)


def _check_march_k(k: int):
    if k < 1 or 32 % k:
        raise ValueError(f"march_k={k}: the land march spreads a lane's k probes over k threads "
                         "of a warp, so k must divide 32")


def land_march(topo, pos, direction, active, t_cap, scale: float, *,
               step_floor: float, stall_thresh: float, steps: int, k: int,
               patience: int, any_hit: bool, enable: bool = True, bilinear: bool = False,
               exact_ocean: bool = True, ref_phantom: bool = True, cert_floor: float = None,
               options: bool = False):
    """Launch ``land_march`` (csrc/land_march.cu): (n,) hit distance, -1 on
    a miss. The march gives each marching lane ``k`` threads of its warp:
    ``k`` must divide 32. The march's options (``enable`` False: no land,
    every ray misses; ``bilinear`` taps; the exact ocean root; the phantom
    crawl) or ``options`` launch the options instance; every instance takes
    any ``patience``. ``cert_floor``, the uncertified floor of
    TraceConfig.march_certified_floor (``step_floor`` then the certified
    hop), launches the floor instance, which also takes the options (counted
    as an options launch)."""
    dev = pos.device
    _check_march_k(k)
    flags = (int(enable), int(bilinear), int(exact_ocean), int(ref_phantom))
    cert = cert_floor is not None
    opts = cert or options or flags != tuple(OPTION_DEFAULTS[name] for name in MARCH_OPTIONS)
    n = pos.shape[0]
    h, w = topo.shape[:2]
    _check_tex4("topo", topo, dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("active", active, torch.bool, (n,), dev)
    _check("t_cap", t_cap, torch.float32, (n,), dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        _launch(
            "de_land_march", _ptr(topo), h, w, _ptr(pos), _ptr(direction),
            _ptr(active), _ptr(t_cap), _ptr(out), n, scale, step_floor,
            stall_thresh, steps, k, patience, int(any_hit), int(opts), *flags, int(cert),
            cert_floor if cert else 0.0,
        )
        _count(land_march, 1, opts)
    return out


def rmo_delta_track(keys, pos, direction, t_start, t_max, ext_h, active, *,
                    max_steps: int, k: int, o3_env_peak: float, fast_rng: bool = False):
    """Launch ``rmo_delta_track`` (csrc/rmo_delta_track.cu):
    (event int32, t, iid int32). ``fast_rng`` (the counter-hash draws of
    TraceConfig.fast_loop_rng) launches the options instance."""
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
            _ptr(t), _ptr(iid), n, max_steps, k, o3_env_peak, int(fast_rng),
        )
        _count(rmo_delta_track, 1, fast_rng)
    return event, t, iid


def rmo_ratio_track(keys, pos, direction, t_start, t_max, ext, max_ext, active, *,
                    max_steps: int, k: int, iters: bool = False, fast_rng: bool = False):
    """Launch ``rmo_ratio_track`` (csrc/rmo_ratio_track.cu): the (n, L)
    transmittance of the gases by ratio tracking at the (n,) packet majorant
    ``max_ext``, ``ext`` the (n, L, 3) extinctions, any L >= 1 (outside
    ``BOUNCE_WIDTHS`` from L's width library); with ``iters``, (trans, the
    (n,) int32 iterations of each lane). ``fast_rng`` launches the options
    instance (the counter-hash draws)."""
    dev = pos.device
    n = pos.shape[0]
    L = ext.shape[1] if ext.dim() == 3 else 0
    if L < 1:
        raise ValueError(f"rmo_ratio_track: extinctions of shape {tuple(ext.shape)}, expected "
                         "(n, L, 3) with L >= 1")
    keys = keys_i32(keys)
    _check("keys", keys, torch.int32, (n, 2), dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("t_start", t_start, torch.float32, (n,), dev)
    _check("t_max", t_max, torch.float32, (n,), dev)
    _check("ext", ext, torch.float32, (n, L, 3), dev)
    _check("max_ext", max_ext, torch.float32, (n,), dev)
    _check("active", active, torch.bool, (n,), dev)
    trans = torch.empty((n, L), dtype=torch.float32, device=dev)
    it = torch.empty((n,), dtype=torch.int32, device=dev) if iters else None
    if n:
        _launch(
            "de_rmo_ratio_track", _ptr(keys), _ptr(pos), _ptr(direction), _ptr(t_start),
            _ptr(t_max), _ptr(ext), _ptr(max_ext), _ptr(active), _ptr(trans), _ptr_or_null(it),
            n, L, max_steps, k, int(fast_rng), width=L,
        )
        _count(rmo_ratio_track, 1, fast_rng, width=L)
    return (trans, it) if iters else trans


def cloud_track(keys, pos, direction, t_start, t_max, ext_w, active, clouds, *,
                max_steps: int, k: int, ratio: bool, bilinear: bool = False,
                fast_rng: bool = False, options: bool = False):
    """Launch ``cloud_track`` (csrc/cloud_track.cu): (event int32, t) in
    delta mode, the (n,) transmittance in ratio mode. ``bilinear`` taps,
    ``fast_rng`` draws (or ``options``) launch an options instance (the
    counter-hash draws one of their own)."""
    opts = options or bilinear or fast_rng
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
    _check_tex4("clouds", clouds, dev)
    event = torch.empty((n,), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    trans = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        _launch(
            "de_cloud_track", _ptr(keys), _ptr(pos), _ptr(direction),
            _ptr(t_start), _ptr(t_max), _ptr(ext_w), _ptr(active),
            _ptr(clouds), h, w, _ptr(event), _ptr(t), _ptr(trans), n,
            max_steps, k, int(ratio), int(opts), int(bilinear), int(fast_rng),
        )
        _count(cloud_track, 1, opts)
    return trans if ratio else (event, t)


def flight_analytic(keys, pos, direction, t_start, t_max, ext_h, active, table, *,
                    n_iter: int, iters: bool = False):
    """Launch ``flight_analytic`` (csrc/flight_analytic.cu): the gases'
    free-flight event (event int32, t, iid int32) by inverting their optical
    depth on the (384, 1024, 3) density ``table`` with ``n_iter`` Newton
    steps, ``ext_h`` the (n, 3) hero extinction; with ``iters``, (that, the
    (n,) int32 steps of each lane: ``n_iter`` where it collides, else 0)."""
    dev = pos.device
    n = pos.shape[0]
    if n_iter < 0:
        raise ValueError(f"flight_analytic: {n_iter} Newton steps")
    keys = keys_i32(keys)
    _check("keys", keys, torch.int32, (n, 2), dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("t_start", t_start, torch.float32, (n,), dev)
    _check("t_max", t_max, torch.float32, (n,), dev)
    _check("ext_h", ext_h, torch.float32, (n, 3), dev)
    _check("active", active, torch.bool, (n,), dev)
    _check("table", table, torch.float32, (384, 1024, 3), dev)
    event = torch.empty((n,), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    iid = torch.empty((n,), dtype=torch.int32, device=dev)
    it = torch.empty((n,), dtype=torch.int32, device=dev) if iters else None
    if n:
        _launch("de_flight_analytic", _ptr(keys), _ptr(pos), _ptr(direction), _ptr(t_start),
                _ptr(t_max), _ptr(ext_h), _ptr(active), _ptr(table), _ptr(event), _ptr(t),
                _ptr(iid), _ptr_or_null(it), n, n_iter)
        _count(flight_analytic, 1)
    out = (event, t, iid)
    return (out, it) if iters else out


def naive_march(topo, pos, direction, active, scale: float, *, steps: int,
                enable: bool = True, bilinear: bool = False, iters: bool = False):
    """Launch ``naive_march`` (csrc/naive_march.cu), the reference's plain
    sphere march, block-cooperative: (n,) hit distance, -1 on a miss (every ray without land,
    ``enable`` False); with ``iters``, (the distances, each lane's (n,)
    int32 steps)."""
    dev = pos.device
    n = pos.shape[0]
    h, w = topo.shape[:2]
    _check_tex4("topo", topo, dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("active", active, torch.bool, (n,), dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    it = torch.empty((n,), dtype=torch.int32, device=dev) if iters else None
    if n:
        _launch("de_naive_march", _ptr(topo), h, w, _ptr(pos), _ptr(direction), _ptr(active),
                _ptr(out), _ptr_or_null(it), n, scale, steps, int(enable), int(bilinear))
        _count(naive_march, 1)
    return (out, it) if iters else out


def naive_march_loop(topo, pos, direction, active, scale: float, *, steps: int,
                     bilinear: bool = False, census: bool = False):
    """Measurement launcher of the plain march (not a path kernel): the
    one-thread loop, the design ``naive_march``'s block replaced
    (csrc/bench/naive_march_bench.cu naive_march_loop, in ``bench_library``):
    (the (n,) hit distances, each lane's (n,) int32 steps); with ``census``
    (nearest taps only) also each lane's (n, 4) int64 clock64 cycles: the
    point and its divisions, the angles, the tap's read, the rest."""
    dev = pos.device
    n = pos.shape[0]
    h, w = topo.shape[:2]
    if census and bilinear:
        raise ValueError("naive_march_loop: the census takes nearest taps only")
    _check_tex4("topo", topo, dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("active", active, torch.bool, (n,), dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    it = torch.empty((n,), dtype=torch.int32, device=dev)
    cycles = torch.empty((n, 4), dtype=torch.int64, device=dev) if census else None
    if n:
        _launch("de_naive_march_loop", _ptr(topo), h, w, _ptr(pos), _ptr(direction),
                _ptr(active), _ptr(out), _ptr(it), _ptr_or_null(cycles), n, scale, steps,
                int(bilinear))
    return (out, it, cycles) if census else (out, it)


NAIVE_SPECIES = ("rmo", "cloud")


def _naive_track(fn, keys, pos, direction, t_start, t_max, ext, max_ext, active, clouds,
                 species, max_steps, bilinear, iters, ratio):
    dev = pos.device
    n = pos.shape[0]
    if species not in NAIVE_SPECIES:
        raise ValueError(f"{fn.__name__}: species {species!r}, expected one of {NAIVE_SPECIES}")
    keys = keys_i32(keys)
    _check("keys", keys, torch.int32, (n, 2), dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("t_start", t_start, torch.float32, (n,), dev)
    _check("t_max", t_max, torch.float32, (n,), dev)
    _check("ext", ext, torch.float32, (n, 4), dev)
    _check("max_ext", max_ext, torch.float32, (n,), dev)
    _check("active", active, torch.bool, (n,), dev)
    cloud = species == "cloud"
    if cloud:
        _check_tex4("clouds", clouds, dev)
    h, w = clouds.shape[:2] if cloud else (0, 0)
    event = torch.empty((n,), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    iid = torch.empty((n,), dtype=torch.int32, device=dev)
    trans = torch.empty((n,), dtype=torch.float32, device=dev)
    it = torch.empty((n,), dtype=torch.int32, device=dev) if iters else None
    if n:
        _launch("de_naive_track", _ptr(keys), _ptr(pos), _ptr(direction), _ptr(t_start),
                _ptr(t_max), _ptr(ext), _ptr(max_ext), _ptr(active),
                _ptr(clouds) if cloud else None, h, w, _ptr(event), _ptr(t), _ptr(iid),
                _ptr(trans), _ptr_or_null(it), n, max_steps, int(cloud), int(ratio),
                int(bilinear))
        _count(fn, 1)
    out = trans if ratio else (event, t, iid)
    return (out, it) if iters else out


def naive_delta_track(keys, pos, direction, t_start, t_max, ext, max_ext, active, clouds=None,
                      *, species: str, max_steps: int, bilinear: bool = False,
                      iters: bool = False):
    """Launch ``naive_delta_track`` (csrc/naive_track.cu): one-step Woodcock
    tracking at the (n,) global majorant ``max_ext`` of ``species`` ("rmo":
    the gases, channels 0-2 of the (n, 4) extinctions ``ext``; "cloud": the
    cloud map's density, channel 3, taps bilinear where ``bilinear``), as
    warp-cooperative steps: (event int32, t, iid int32); with ``iters``,
    (that, each lane's (n,) int32 steps)."""
    return _naive_track(naive_delta_track, keys, pos, direction, t_start, t_max, ext, max_ext,
                        active, clouds, species, max_steps, bilinear, iters, ratio=False)


def naive_ratio_track(keys, pos, direction, t_start, t_max, ext, max_ext, active, clouds=None,
                      *, species: str, max_steps: int, bilinear: bool = False,
                      iters: bool = False):
    """Launch ``naive_ratio_track`` (csrc/naive_track.cu): the (n,)
    transmittance by one-step ratio tracking (arguments as
    ``naive_delta_track`` takes them; the gases' one thread a lane)."""
    return _naive_track(naive_ratio_track, keys, pos, direction, t_start, t_max, ext, max_ext,
                        active, clouds, species, max_steps, bilinear, iters, ratio=True)


def atmos_phase_constants(mie_e: float):
    """The float32 phase constants of the single-scatter march (rayl_k,
    mie_e, two_pi, log_term), as ``atmos_march`` and ``preview`` take them."""
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    return [f32(3.0 / (16.0 * math.pi)), f32(mie_e), f32(2.0 * math.pi),
            float(torch.log(torch.tensor(2.0 * mie_e + 1.0, dtype=torch.float32)))]


def atmos_march(pos, direction, t_start, t_max, sun_dir, ext_rmo, scattering,
                active, *, mie_e: float):
    """Launch ``atmos_march`` (csrc/atmos_march.cu): (in_scatter, trans),
    (0, 1) on lanes that are not ``active``."""
    dev = pos.device
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("t_start", t_start, torch.float32, (n,), dev)
    _check("t_max", t_max, torch.float32, (n,), dev)
    _check("sun_dir", sun_dir, torch.float32, (n, 3), dev)
    _check("ext_rmo", ext_rmo, torch.float32, (n, 3), dev)
    _check("scattering", scattering, torch.float32, (n, 2), dev)
    _check("active", active, torch.bool, (n,), dev)
    in_scatter = torch.empty((n,), dtype=torch.float32, device=dev)
    trans = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        _launch(
            "de_atmos_march", _ptr(pos), _ptr(direction), _ptr(t_start),
            _ptr(t_max), _ptr(sun_dir), _ptr(ext_rmo), _ptr(scattering),
            _ptr(active), _ptr(in_scatter), _ptr(trans), n, *atmos_phase_constants(mie_e),
        )
        _count(atmos_march, 1)
    return in_scatter, trans


def gen_rays(fparams, iparams, g, cie_response, n: int, n_lambdas: int, tile_ids=None,
             tile_map: bool = False):
    """Launch ``gen_rays`` (csrc/gen_rays.cu) for ``n`` lanes at ``n_lambdas``
    = L wavelengths (outside ``BOUNCE_WIDTHS`` from L's width library):
    (keys (n, 2) int64, dirs (n, 3), wavelengths (n, L), responses (n, L, 3), pdf (n, L),
    pid (n,) int64, and with ``tile_map`` each lane's tile index and in-tile
    lane (n,) int64, else None, None). ``fparams`` (19 floats) and
    ``iparams`` (13 ints; the last is 1 for the stratified primary samples,
    0 for independent ones) are laid out as the C entry de_gen_rays documents
    (render/raygen.py builds them on the host); ``tile_ids`` is an int32
    tile list (lane l in tile tile_ids[l // tile]) or None. Reads nothing
    back from the card, so a CUDA graph can capture it."""
    dev = g.device
    res = g.shape[0]
    if len(fparams) != 19 or len(iparams) != 13:
        raise ValueError("gen_rays: expected 19 float and 13 int parameters")
    _check("g", g, torch.float32, (res,), dev)
    _check("cie_response", cie_response, torch.float32, (res, 3), dev)
    if n_lambdas < 1 or not 2 <= res <= 3072:
        raise ValueError(f"gen_rays: {n_lambdas} wavelengths (at least 1), a table of {res} "
                         "(2-3072)")
    if iparams[10] != n_lambdas or iparams[12] not in (0, 1):
        raise ValueError(f"gen_rays: {iparams[10]} wavelengths in the parameters for {n_lambdas}, "
                         f"stratify flag {iparams[12]} (0 or 1)")
    lane0 = iparams[4]
    if lane0 < 0 or lane0 + n >= 2**31:
        raise ValueError(f"gen_rays: lanes [{lane0}, {lane0 + n}) outside [0, 2^31)")
    if tile_ids is not None:
        _check("tile_ids", tile_ids, torch.int32, (tile_ids.shape[0],), dev)
        tile = iparams[7] * iparams[8]
        if lane0 + n > tile_ids.shape[0] * tile:
            raise ValueError("gen_rays: lanes beyond the tile list")
    keys = torch.empty((n, 2), dtype=torch.int64, device=dev)
    dirs = torch.empty((n, 3), dtype=torch.float32, device=dev)
    wavelengths = torch.empty((n, n_lambdas), dtype=torch.float32, device=dev)
    responses = torch.empty((n, n_lambdas, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty((n, n_lambdas), dtype=torch.float32, device=dev)
    pid = torch.empty((n,), dtype=torch.int64, device=dev)
    tidx = torch.empty((n,), dtype=torch.int64, device=dev) if tile_map else None
    li = torch.empty((n,), dtype=torch.int64, device=dev) if tile_map else None
    if n:
        fp = (ctypes.c_float * 19)(*fparams)
        ip = (ctypes.c_int64 * 13)(*iparams)
        _launch(
            "de_gen_rays", ctypes.cast(fp, ctypes.c_void_p), ctypes.cast(ip, ctypes.c_void_p),
            _ptr(g), _ptr(cie_response), _ptr(keys), _ptr(dirs), _ptr(wavelengths),
            _ptr(responses), _ptr(pdf), _ptr(pid), _ptr_or_null(tidx), _ptr_or_null(li),
            _ptr_or_null(tile_ids), n, width=n_lambdas,
        )
        _count(gen_rays, 1, width=n_lambdas)
    return keys, dirs, wavelengths, responses, pdf, pid, tidx, li


def frame_end(fparams, iparams, radiance, responses, pid, color, count=None, lum2=None, *,
              pdf=None, miss=None):
    """Launch ``frame_end`` (csrc/frame_end.cu) for the n lanes of a frame,
    chunk or tile list: deposit each lane's RGB into ``color`` (P, 3) at its
    pixel ``pid`` (n,) int64, and with ``count``/``lum2`` (P,) add 1 and lum^2
    there. The kernel uses no atomics: ``pid`` must hold distinct pixels, as
    every pass's lanes do. Preview mode passes ``pdf`` (n, 1); path mode
    passes ``miss``, the miss-shading inputs (throughput, w_mis, lambda_pdf,
    wavelength, direction, primary_miss, light_direction, sun_cos_angle,
    stars, srgb2spec). ``fparams`` (17 floats) and ``iparams`` (5 ints) are
    laid out as de_frame_end documents (render/frame_end.py builds them). A
    packet wider than ``FRAME_END_MAX_LAMBDAS`` runs from its width library."""
    dev = radiance.device
    n = pid.shape[0]
    n_l = iparams[0]
    n_pix = color.shape[0]
    if len(fparams) != 17 or len(iparams) != 5:
        raise ValueError("frame_end: expected 17 float and 5 int parameters")
    if n_l < 1:
        raise ValueError(f"frame_end: {n_l} wavelengths per lane")
    if (pdf is None) == (miss is None):
        raise ValueError("frame_end: pass pdf (preview) or miss (path), not both")
    if (count is None) != (lum2 is None):
        raise ValueError("frame_end: pass count and lum2 together")
    _check("radiance", radiance, torch.float32, (n, n_l), dev)
    _check("responses", responses, torch.float32, (n, n_l, 3), dev)
    _check("pid", pid, torch.int64, (n,), dev)
    _check("color", color, torch.float32, (n_pix, 3), dev)
    if count is not None:
        _check("count", count, torch.float32, (n_pix,), dev)
        _check("lum2", lum2, torch.float32, (n_pix,), dev)
    if pdf is not None:
        _check("pdf", pdf, torch.float32, (n, 1), dev)
        ptrs = [_ptr(pdf)] + [None] * 10
    else:
        sh, sw = iparams[1], iparams[2]
        shapes = [(n, n_l)] * 4 + [(n, 3), (n,), (3,), (), (sh, sw, 3), (300, 3)]
        names = ("throughput", "w_mis", "lambda_pdf", "wavelength", "direction",
                 "primary_miss", "light_direction", "sun_cos_angle", "stars", "srgb2spec")
        dtypes = [torch.float32] * 5 + [torch.bool, torch.float32, torch.float32, torch.uint8,
                                        torch.float32]
        for name, t, dtype, shape in zip(names, miss, dtypes, shapes):
            _check(name, t, dtype, shape, dev)
        ptrs = [None] + [_ptr(t) for t in miss]
    if n:
        fp = (ctypes.c_float * 17)(*fparams)
        ip = (ctypes.c_int * 5)(*iparams)
        _launch(
            "de_frame_end", ctypes.cast(fp, ctypes.c_void_p), ctypes.cast(ip, ctypes.c_void_p),
            _ptr(radiance), _ptr(responses), *ptrs, _ptr(pid), _ptr(color),
            _ptr_or_null(count), _ptr_or_null(lum2), n,
            width=n_l if n_l > FRAME_END_MAX_LAMBDAS else None,
        )
        _count(frame_end, 1, width=n_l)


SELECT_TILES_STAGES = 2  # kernel launches per call up to SELECT_SORT_MAX tiles
# the most tiles one block ranks (csrc/select_tiles.cu SORT_MAX); past it
# the rank sorts runs of this many keys and merges them in two more launches
SELECT_SORT_MAX = 8192
_select_scratch = {}  # device -> _SelectScratch


def select_launches(n_tiles: int) -> int:
    """Kernel launches of one ``select_tiles`` call over ``n_tiles`` tiles
    (a shard step's: one fewer, its mean being ``shard_mean``'s)."""
    return SELECT_TILES_STAGES + (2 if n_tiles > SELECT_SORT_MAX else 0)


class _SelectScratch:
    """The scratch ``select_tiles`` and its shard entries keep per device,
    each part its own tensor: the ticket counters (int32 (2,), [0] for
    launch A, [1] for launch B; zero between calls), m_bar (1,), the tile
    scores, the chunk partials and, past SELECT_SORT_MAX tiles, the sorted
    runs of rank keys (each grown when a call needs more; an outgrown tensor
    is kept, so that a graph captured on it stays valid).
    Kept, not allocated per call, so a call allocates only its outputs and
    a CUDA graph can capture it, once a call outside the capture has made
    the scratch at its size. Calls on one device use it in stream order."""

    def __init__(self, dev):
        self.counter = torch.zeros((2,), dtype=torch.int32, device=dev)
        self.m_bar = torch.zeros((1,), dtype=torch.float32, device=dev)
        self.score = torch.zeros((0,), dtype=torch.float32, device=dev)
        self.partial = torch.zeros((0,), dtype=torch.float32, device=dev)
        self.runs = torch.zeros((0,), dtype=torch.int64, device=dev)
        self.outgrown = []

    @staticmethod
    def get(dev, n_tiles: int = 0, n_part: int = 0):
        scratch = _select_scratch.get(dev)
        if scratch is None:
            scratch = _select_scratch[dev] = _SelectScratch(dev)
        n_keys = -(-n_tiles // SELECT_SORT_MAX) * SELECT_SORT_MAX if n_tiles > SELECT_SORT_MAX else 0
        for name, n, dtype in (("score", n_tiles, torch.float32),
                               ("partial", n_part, torch.float32), ("runs", n_keys, torch.int64)):
            if getattr(scratch, name).numel() < n:
                scratch.outgrown.append(getattr(scratch, name))
                setattr(scratch, name, torch.empty((n,), dtype=dtype, device=dev))
        return scratch

    def counter_ptr(self, launch: int):
        return ctypes.c_void_p(self.counter.data_ptr() + 4 * launch)


def select_tiles(fparams, color, count, lum2, block, k: int, stats: bool = False):
    """Launch ``select_tiles`` (csrc/select_tiles.cu): the (k,) int32 ids of
    the tiles of ``block`` with the highest scores, in descending order, ties
    to the lower id; with ``stats``, (ids, m_bar (1,), scores (n_tiles,)),
    copies of the scratch. ``color`` (W, H, 3), ``count`` and ``lum2`` (W,
    H); ``fparams`` (5 floats) as de_select_tiles documents
    (render/adaptive.py builds them). Two launches, four past
    ``SELECT_SORT_MAX`` tiles; no read of the card."""
    dev = color.device
    w, h = color.shape[:2]
    bw, bh = block
    n_tiles = (w // bw) * (h // bh)
    _check("color", color, torch.float32, (w, h, 3), dev)
    _check("count", count, torch.float32, (w, h), dev)
    _check("lum2", lum2, torch.float32, (w, h), dev)
    if len(fparams) != 5:
        raise ValueError("select_tiles: expected 5 float parameters")
    if not 1 <= k <= n_tiles or w % bw or h % bh:
        raise ValueError(f"select_tiles: k={k} of {n_tiles} tiles of {block} in {w}x{h}")
    scratch = _SelectScratch.get(dev, n_tiles, -(-w * h // 1024))
    ids = torch.empty((k,), dtype=torch.int32, device=dev)
    fp = (ctypes.c_float * 5)(*fparams)
    _launch(
        "de_select_tiles", ctypes.cast(fp, ctypes.c_void_p), _ptr(color), _ptr(count),
        _ptr(lum2), w, h, bw, bh, k, _ptr(scratch.partial), _ptr(scratch.m_bar),
        _ptr(scratch.score), scratch.counter_ptr(0), _ptr(scratch.runs), _ptr(ids),
    )
    _count(select_tiles, select_launches(n_tiles))
    if stats:
        return ids, scratch.m_bar.clone(), scratch.score[:n_tiles].clone()
    return ids


def _check_shard(color, count, lum2=None):
    dev = color.device
    n_pix = count.shape[0]
    _check("color", color, torch.float32, (n_pix, 3), dev)
    _check("count", count, torch.float32, (n_pix,), dev)
    if lum2 is not None:
        _check("lum2", lum2, torch.float32, (n_pix,), dev)
    return dev, n_pix


def shard_mean(fparams, color, count):
    """Launch A of ``select_tiles`` (csrc/select_tiles.cu, de_shard_mean) on
    one device's flat shard: the (1,) mean over its pixels of lum(color) /
    max(count, 1). ``color`` (P, 3), ``count`` (P,)."""
    dev, n_pix = _check_shard(color, count)
    if len(fparams) != 5 or n_pix < 1:
        raise ValueError("shard_mean: expected 5 float parameters and a non-empty shard")
    scratch = _SelectScratch.get(dev, n_part=-(-n_pix // 1024))
    mean = torch.empty((1,), dtype=torch.float32, device=dev)
    fp = (ctypes.c_float * 5)(*fparams)
    _launch("de_shard_mean", ctypes.cast(fp, ctypes.c_void_p), _ptr(color), _ptr(count), n_pix,
            _ptr(scratch.partial), scratch.counter_ptr(0), _ptr(mean))
    _count(select_tiles_shard, SELECT_TILES_STAGES // 2)
    return mean


def select_tiles_shard(fparams, color, count, lum2, tile: int, k: int, m_bar,
                       stats: bool = False):
    """Launch B of ``select_tiles`` (csrc/select_tiles.cu,
    de_select_tiles_shard) on one device's flat tile-major shard of
    ``tile``-pixel tiles: the (k,) int32 shard-local ids of the best tiles
    scored against the frame mean ``m_bar`` (1,) on the same device, in
    descending order, ties to the lower id; with ``stats``, (ids, scores).
    Its launches count with ``shard_mean``'s: one, three past
    ``SELECT_SORT_MAX`` tiles."""
    dev, n_pix = _check_shard(color, count, lum2)
    _check("m_bar", m_bar, torch.float32, (1,), dev)
    if len(fparams) != 5:
        raise ValueError("select_tiles_shard: expected 5 float parameters")
    if tile < 1 or n_pix % tile or not 1 <= k <= n_pix // tile:
        raise ValueError(f"select_tiles_shard: k={k} of {n_pix} pixels in tiles of {tile}")
    n_tiles = n_pix // tile
    scratch = _SelectScratch.get(dev, n_tiles)
    ids = torch.empty((k,), dtype=torch.int32, device=dev)
    fp = (ctypes.c_float * 5)(*fparams)
    _launch("de_select_tiles_shard", ctypes.cast(fp, ctypes.c_void_p), _ptr(color), _ptr(count),
            _ptr(lum2), n_tiles, tile, k, _ptr(m_bar), _ptr(scratch.score),
            scratch.counter_ptr(1), _ptr(scratch.runs), _ptr(ids))
    _count(select_tiles_shard, select_launches(n_tiles) - SELECT_TILES_STAGES // 2)
    return (ids, scratch.score[:n_tiles].clone()) if stats else ids


# film_postprocess's float parameters after the two matrices, by name in
# render/film.kernel_constants
_FILM_CONSTANTS = ("DRT_M", "DRT_S", "DRT_DS", "DRT_CLAMP", "DCH_S", "LW0", "LW1", "LW2")


def film_postprocess(color_buffer, count, spp: float, exposure_scale: float,
                     gamma: float, crf_curves, crf_index: int, drt: int,
                     constants: dict):
    """Launch ``film_postprocess`` (csrc/film_postprocess.cu): (W, H, 3)
    display sRGB. ``count`` is a (W, H, 1) per-pixel sample count or None
    (then the scalar ``spp``); ``drt`` is 0 (OpenDRT), 1 (AgX) or 2 (none);
    ``constants`` holds the display transform's matrices (A00 ... B22) and
    tone-scale constants (render/film.kernel_constants)."""
    dev = color_buffer.device
    w, h = color_buffer.shape[:2]
    res, n_films = crf_curves.shape[:2]
    _check("color_buffer", color_buffer, torch.float32, (w, h, 3), dev)
    _check("crf_curves", crf_curves, torch.float32, (res, n_films, 3), dev)
    if count is not None:
        _check("count", count, torch.float32, (w, h, 1), dev)
    if drt not in (0, 1, 2) or not 0 <= crf_index < n_films:
        raise ValueError(f"film_postprocess: drt={drt}, film {crf_index} of {n_films}")
    out = torch.empty((w, h, 3), dtype=torch.float32, device=dev)
    if w * h:
        mats = [constants[f"{m}{i}{j}"] for m in "AB" for i in range(3) for j in range(3)]
        fp = (ctypes.c_float * 29)(*mats, *(constants[k] for k in _FILM_CONSTANTS), float(spp),
                                   float(exposure_scale), float(gamma))
        ip = (ctypes.c_int * 7)(drt, int(count is not None), res, n_films, crf_index, w, h)
        _launch("de_film_postprocess", ctypes.cast(fp, ctypes.c_void_p),
                ctypes.cast(ip, ctypes.c_void_p), _ptr(color_buffer), _ptr_or_null(count),
                _ptr(crf_curves), _ptr(out))
        _count(film_postprocess, 1)
    return out


# the scene and march flags, then the naive arm's (render/params.NAIVE_OPTIONS),
# that follow the bounce entries' sixteen ints, in order (the stall
# patience, int 5, is a run-time parameter of every instance)
BOUNCE_OPTIONS = ("enable_clouds", "enable_land", "bilinear_tracking", "lazy_march",
                  "march_exact_ocean", "march_ref_phantom", "naive_tracking", "naive_march",
                  "naive_cloud_tracking", "naive_shadow")
# the estimator options (render/params.ESTIMATOR_OPTIONS) and the certified
# floor with their defaults: the ints that follow BOUNCE_OPTIONS in the int
# block (the Newton steps and the roulettes' start bounces act only with
# their options), and the two probabilities that follow the sixteen floats,
# each with its reciprocal float32(1 / p) after it
BOUNCE_ESTIMATOR_INTS = dict(analytic_flight=0, flight_newton_iters=14, fast_loop_rng=0,
                             nee_rr_start=9, cloud_rr_start=9, nee_off=0, march_certified_floor=0)
BOUNCE_ESTIMATOR_FLOATS = dict(nee_rr_prob=1.0, cloud_rr_keep=1.0)
_ESTIMATOR_FLAGS = ("analytic_flight", "fast_loop_rng", "nee_off", "march_certified_floor")
# the march floors' floats, after the estimator options' probabilities: the
# primary marches' step floor and stall threshold at bounce 0 and past it
# (TraceConfig.march_floor_frac_secondary) and the uncertified floor
# (march_certified_floor); at their defaults the primary marches' are the
# shadow march's, floats 1 and 2 (render/tracers.MarchFloor)
BOUNCE_FLOOR_FLOATS = ("floor_first", "stall_first", "floor_past", "stall_past", "floor_uncert")
# the bounce entries' instances (csrc/bounce.cuh INST_*): the default, the
# options instance (the scene and march options, the naive arm), the
# estimator instance (those and the estimator options) and the floor
# instance (those and the march floors)
INST_DEFAULT, INST_OPTIONS, INST_ESTIMATOR, INST_FLOORS = 0, 1, 2, 3
# the bounce entries' parameter blocks as the wrappers take them; the C
# entries' int block has one more, the instance (csrc/bounce.cu)
BOUNCE_FLOATS = 16 + 2 * len(BOUNCE_ESTIMATOR_FLOATS) + len(BOUNCE_FLOOR_FLOATS)
BOUNCE_INTS = 16 + len(BOUNCE_OPTIONS) + len(BOUNCE_ESTIMATOR_INTS)
BOUNCE_SITES = 7  # the census's loop sites (csrc/bounce.cuh SITE_*)
# the census's clock64 columns: the seven sites, then bounce_flight's and
# bounce_shade's whole, then the shade's surface branch (the normal's four
# topography taps and the material tap; csrc/bounce.cuh CYCLE_COLS)
BOUNCE_CYCLE_COLS = BOUNCE_SITES + 3
# de_bounce_occupancy's entries
OCCUPANCY_ENTRIES = ("bounce_flight", "bounce_shade", "bounce_window")


def _options_instance(iparams, first: int, names, force: bool) -> bool:
    """Whether a launch takes the options instance: ``force``, or a flag of
    the int block (``names`` from int ``first`` on) off its default. Raises
    on a flag other than 0 or 1."""
    flags = iparams[first:first + len(names)]
    if any(v not in (0, 1) for v in flags):
        raise ValueError(f"options {dict(zip(names, flags))}: each flag 0 or 1")
    return bool(force or any(v != OPTION_DEFAULTS[name] for name, v in zip(names, flags)))


def bounce_estimator_params(cfg):
    """(the ints, the floats) of the estimator options ``cfg`` (a
    TraceConfig) gives the bounce entries: the ints of
    ``BOUNCE_ESTIMATOR_INTS`` in order, and each probability of
    ``BOUNCE_ESTIMATOR_FLOATS`` with its reciprocal, the Python float's
    (float32 once in the parameter block)."""
    ints = [int(getattr(cfg, name)) for name in BOUNCE_ESTIMATOR_INTS]
    floats = []
    for name in BOUNCE_ESTIMATOR_FLOATS:
        p = float(getattr(cfg, name))
        floats += [p, 1.0 / p]
    return ints, floats


def _knob_instance(fparams, iparams) -> int:
    """The instance the estimator options and the march floors of a bounce
    launch's blocks ask for: ``INST_FLOORS`` at a march floor off its
    default (the certified floor, or a primary march's floor or stall
    threshold not the shadow march's, floats 1 and 2), else
    ``INST_ESTIMATOR`` at an estimator option off its default, else 0.
    Raises on a flag other than 0 or 1, negative Newton steps, a probability
    outside (0, 1] or a floor not above 0."""
    first = 16 + len(BOUNCE_OPTIONS)
    ints = dict(zip(BOUNCE_ESTIMATOR_INTS, iparams[first:]))
    n_probs = 2 * len(BOUNCE_ESTIMATOR_FLOATS)
    probs = dict(zip(BOUNCE_ESTIMATOR_FLOATS, fparams[16:16 + n_probs:2]))
    floors = dict(zip(BOUNCE_FLOOR_FLOATS, fparams[16 + n_probs:]))
    if (any(ints[name] not in (0, 1) for name in _ESTIMATOR_FLAGS)
            or ints["flight_newton_iters"] < 0 or any(not 0.0 < p <= 1.0 for p in probs.values())
            or any(not f > 0.0 for f in floors.values())):
        raise ValueError(f"bounce: estimator options {ints}, {probs}, floors {floors}")
    shadow = list(fparams[1:3])
    if (ints["march_certified_floor"]
            or [floors["floor_first"], floors["stall_first"]] != shadow
            or [floors["floor_past"], floors["stall_past"]] != shadow):
        return INST_FLOORS
    if (any(v != BOUNCE_ESTIMATOR_INTS[name] for name, v in ints.items())
            or any(p != 1.0 for p in probs.values())):
        return INST_ESTIMATOR
    return 0


def _width_instance(opts: int) -> int:
    """The instance a width library runs for ``opts``: the default instance,
    or for any other the floor instance (which reads every option)."""
    return INST_DEFAULT if opts == INST_DEFAULT else INST_FLOORS


def _bounce_args(fparams, iparams, pos, direction, wavelength, lambda_pdf, throughput, radiance,
                 w_mis, alive, primary_miss, work_class, keys, idx, topo, material, clouds,
                 o3_crossec, srgb2spec, table, n_live, options=False):
    """Check a bounce launch's arguments: (the C arguments up to the tables,
    the ctypes blocks they point to, the instance the options ask for:
    ``INST_*``, the packet width). At a width outside ``BOUNCE_WIDTHS`` the
    C block asks for the width library's default instance where every option
    is at its default, else for its floor instance (which reads every option
    at run time)."""
    dev = pos.device
    n = pos.shape[0]
    m = idx.shape[0]
    if len(fparams) != BOUNCE_FLOATS or len(iparams) != BOUNCE_INTS:
        raise ValueError(f"bounce: expected {BOUNCE_FLOATS} float and {BOUNCE_INTS} int "
                         "parameters")
    L = iparams[0]
    if L < 1:
        raise ValueError(f"bounce: {L} wavelengths per lane")
    if iparams[15] not in (0, 1):
        raise ValueError(f"bounce: ratio flag {iparams[15]}, expected 0 or 1")
    if iparams[16 + BOUNCE_OPTIONS.index("naive_tracking")] and L != 1:
        raise ValueError(f"bounce: naive_tracking at {L} wavelengths per lane, the naive "
                         "trackers take 1")
    _check_march_k(iparams[4])
    for name, t in (("pos", pos), ("direction", direction)):
        _check(name, t, torch.float32, (n, 3), dev)
    for name, t in (("wavelength", wavelength), ("lambda_pdf", lambda_pdf),
                    ("throughput", throughput), ("radiance", radiance), ("w_mis", w_mis)):
        _check(name, t, torch.float32, (n, L), dev)
    _check("alive", alive, torch.bool, (n,), dev)
    _check("primary_miss", primary_miss, torch.bool, (n,), dev)
    _check("work_class", work_class, torch.int32, (n,), dev)
    _check("keys", keys, torch.int32, (n, 2), dev)
    _check("idx", idx, torch.int32, (m,), dev)
    if n_live is not None:
        _check("n_live", n_live, torch.int32, (1,), dev)
    if m > n:
        raise ValueError(f"bounce: {m} lane ids for {n} lanes")
    _check_tex4("topo", topo, dev)
    _check_tex8("material", material, dev)
    _check_tex4("clouds", clouds, dev)
    if tuple(iparams[9:15]) != (*topo.shape[:2], *material.shape[:2], *clouds.shape[:2]):
        raise ValueError("bounce: texture sizes disagree with the int parameters")
    _check("o3_crossec", o3_crossec, torch.float32, (441,), dev)
    _check("srgb2spec", srgb2spec, torch.float32, (300, 3), dev)
    _check("table", table, torch.float32, (384, 1024, 3), dev)
    scene = _options_instance(iparams, 16, BOUNCE_OPTIONS, options)
    opts = _knob_instance(fparams, iparams) or (INST_OPTIONS if scene else INST_DEFAULT)
    fp = (ctypes.c_float * BOUNCE_FLOATS)(*fparams)
    inst = opts if L in BOUNCE_WIDTHS else _width_instance(opts)
    ip = (ctypes.c_int * (BOUNCE_INTS + 1))(*iparams, inst)
    return [
        ctypes.cast(fp, ctypes.c_void_p), ctypes.cast(ip, ctypes.c_void_p),
        _ptr(pos), _ptr(direction), _ptr(wavelength), _ptr(lambda_pdf), _ptr(throughput),
        _ptr(radiance), _ptr(w_mis), _ptr(alive), _ptr(primary_miss), _ptr(work_class),
        _ptr(keys), _ptr(idx), _ptr_or_null(n_live), m, n, _ptr(topo), _ptr(material),
        _ptr(clouds), _ptr(o3_crossec), _ptr(srgb2spec), _ptr(table),
    ], (fp, ip), opts, L


def _census_args(trips, cycles, m, dev):
    if trips is not None:
        _check("trips", trips, torch.int32, (m, BOUNCE_SITES), dev)
    if cycles is not None:
        if trips is None:
            raise ValueError("bounce: cycles come from the census instance: pass trips too")
        _check("cycles", cycles, torch.int64, (m, BOUNCE_CYCLE_COLS), dev)
    return _ptr_or_null(trips), _ptr_or_null(cycles)


def bounce_flight(*args, n_live=None, trips=None, cycles=None, options=False):
    """Launch ``bounce_flight`` (csrc/bounce.cu), steps 1-3 of one bounce of
    the lanes ``idx`` (m,) int32 of the (N, ...) state (an id outside [0, N)
    is skipped): the (m, 4) float32 flight outcome of each list entry (t_int,
    earth, event and iid as int32 bits), for ``bounce_shade``. Arguments:
    fparams, iparams, pos, direction, wavelength, lambda_pdf, throughput,
    radiance, w_mis, alive, primary_miss, work_class, keys, idx, topo,
    material, clouds, o3_crossec, srgb2spec, table. ``keys`` are the (N, 2)
    lane keys as int32 (``keys_i32``); ``fparams`` (25 floats: the 16 of
    csrc/bounce.cu, then ``BOUNCE_ESTIMATOR_FLOATS`` each with its
    reciprocal, then ``BOUNCE_FLOOR_FLOATS``) and ``iparams`` (33 ints: the
    16 of csrc/bounce.cu, then the options ``BOUNCE_OPTIONS`` and
    ``BOUNCE_ESTIMATOR_INTS``) are laid out as
    csrc/bounce.cu documents
    (render/pathtracer.py builds them). With ``n_live``, the (1,) int32 live
    count on the device, entries of ``idx`` at or past it are skipped
    (``idx`` is then an upper bound's worth). With ``trips``, an (m, 7)
    int32 tensor, the census instance also writes each entry's trip count
    at the flight's four loop sites (columns 0-3), and with ``cycles``, an
    (m, 10) int64 tensor, its clock64 cycles there and in the whole kernel
    (column 7). The wavelengths per lane (``iparams[0]``) and the sun
    transmittance (``iparams[15]``: 1 ratio tracking, 0 the closed form)
    pick the kernels' instance, an option off its default (or ``options``)
    the options instance of it, an estimator option off its default the
    estimator instance (which also takes the other options), a march floor
    off its default the floor instance (which takes them all); at a width
    outside ``BOUNCE_WIDTHS``, its width library's default instance at the
    defaults and its floor instance at any other setting (counted as an
    options launch). At ``analytic_flight`` the census counts the analytic
    flight's Newton steps at the RMO column (2)."""
    c_args, _refs, opts, L = _bounce_args(*args, n_live, options)
    m = args[13].shape[0]
    dev = args[2].device
    census = _census_args(trips, cycles, m, dev)
    out = torch.empty((m, 4), dtype=torch.float32, device=dev)
    if m:
        _launch("de_bounce_flight", *c_args, _ptr(out), *census, width=L)
        _count(bounce_flight, 1, opts, width=L)
    return out


def bounce_shade(*args, flight, n_live=None, trips=None, cycles=None, options=False):
    """Launch ``bounce_shade`` (csrc/bounce.cu), steps 4-7 of the bounce
    (arguments as ``bounce_flight`` takes them; the state is read and written
    in place), from ``bounce_flight``'s (m, 4) outcome ``flight`` of the same
    list. With ``trips``, the census instance writes the trip counts of the
    shadow march, NEE cloud tracking and NEE RMO ratio tracking (columns
    4-6; column 6 is 0 with the closed form), with ``cycles`` their clock64
    cycles, the whole kernel's (column 8) and the surface branch's, on the
    lanes that reach a surface (column 9; 0 on the others)."""
    c_args, _refs, opts, L = _bounce_args(*args, n_live, options)
    m = args[13].shape[0]
    dev = args[2].device
    _check("flight", flight, torch.float32, (m, 4), dev)
    census = _census_args(trips, cycles, m, dev)
    if m:
        _launch("de_bounce_shade", *c_args, _ptr(flight), *census, width=L)
        _count(bounce_shade, 1, opts, width=L)


def bounce_window(*args, stop: int, n_live=None, options=False):
    """Launch ``bounce_window`` (csrc/bounce.cu): bounces iparams[1] .. stop
    - 1 of each listed lane (arguments as ``bounce_flight`` takes them) in one
    launch, each lane until it dies, its state kept in registers."""
    c_args, _refs, opts, L = _bounce_args(*args, n_live, options)
    m = args[13].shape[0]
    if m and stop > args[1][1]:
        _launch("de_bounce_window", *c_args, int(stop), width=L)
        _count(bounce_window, 1, opts, width=L)


def bounce_occupancy(which: str, options: int = INST_DEFAULT, width: int = None) -> dict:
    """ptxas's and the occupancy calculator's view of a bounce entry
    (``OCCUPANCY_ENTRIES``; its default instance, L = 4 and the closed form,
    or with ``options`` its options instance, True or ``INST_OPTIONS``, its
    estimator instance, ``INST_ESTIMATOR``, or its floor instance,
    ``INST_FLOORS``; with ``width`` outside ``BOUNCE_WIDTHS``, the default
    instance of that width's library, ``INST_DEFAULT``, or any other asks for
    its floor instance) on the current device:
    resident blocks and warps per SM, threads per block, registers and local
    bytes per thread."""
    out = (ctypes.c_int * 4)()
    lib, opts = ((library(), int(options)) if width is None
                 else (width_library(width), _width_instance(int(options))))
    rc = lib.de_bounce_occupancy(OCCUPANCY_ENTRIES.index(which), opts,
                                 ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"de_bounce_occupancy: CUDA error {rc}")
    blocks, block, regs, local = list(out)
    return dict(blocks_per_sm=blocks, warps_per_sm=blocks * block // 32, block=block,
                registers=regs, local_bytes=local)


_window_lanes = {}


def window_threshold(device) -> int:
    """The lanes that fill the card with ``bounce_window``: SMs x its
    resident threads per SM. Below it the path tracer runs the wavefront's
    remaining bounces in one window launch (on an H100, 50,688 lanes:
    bounce 12 of a 1080p Apollo spp, within 2% of the least kernel time
    among window starts 9-14, PERF.md)."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _window_lanes:
        with torch.cuda.device(index):
            occ = bounce_occupancy("bounce_window")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _window_lanes[index] = sms * occ["blocks_per_sm"] * occ["block"]
    return _window_lanes[index]


# kernel launches per compact_lanes call (csrc/compact_lanes.cu): the scratch
# reset (cudaMemsetAsync) and the one-pass kernel
COMPACT_STAGES = 2
_compact_words = {}  # scratch int32 words by lane count


def compact_lanes(alive, work_class):
    """Launch ``compact_lanes`` (csrc/compact_lanes.cu): (idx (n,) int32
    whose first n_live entries are the alive lanes binned by work class in
    stable order, n_live (1,) int32), both on the device."""
    dev = alive.device
    n = alive.shape[0]
    _check("alive", alive, torch.bool, (n,), dev)
    _check("work_class", work_class, torch.int32, (n,), dev)
    if n not in _compact_words:
        _compact_words[n] = library().de_compact_scratch_words(n)
    words = _compact_words[n]
    # one allocation for the scratch (first: its 64-bit status words stay
    # aligned), the count and the list, a call's host time being most of it
    buf = torch.empty((words + 1 + n,), dtype=torch.int32, device=dev)
    scratch, n_live, idx = buf[:words], buf[words:words + 1], buf[words + 1:]
    _launch("de_compact_lanes", _ptr(alive), _ptr(work_class), n, _ptr(idx), _ptr(n_live),
            _ptr(scratch))
    _count(compact_lanes, 1)
    return idx, n_live


def draine_check(u):
    """Test launcher of the bounce's Draine sampler (not a path kernel): for
    each float32 draw ``u`` (n,), the (n, 9) intermediates of
    csrc/volume.cuh sample_draine_cos (t3, t4a, t4, t4p3, t6, t5, inner, s,
    the unclamped cos) and (n,) float32(pow(float64(t4), 1/3)), computed on
    the card by csrc/draine_check.cu."""
    n = u.shape[0]
    _check("u", u, torch.float32, (n,), u.device)
    trace = torch.empty((n, 9), dtype=torch.float32, device=u.device)
    cbrt_f64 = torch.empty_like(u)
    _launch("de_draine_check", _ptr(u), _ptr(trace), _ptr(cbrt_f64), n)
    return trace, cbrt_f64


def density_check(pos, direction, t0, t1, ext_rmo, table):
    """Test launcher of the kernels' density-table header (not a path
    kernel): (segment integrals (n, 3) over [t0, t1], RMO transmittance to
    space (n, 4)), computed on the card by csrc/density_check.cu."""
    dev = pos.device
    n = pos.shape[0]
    L = 4  # csrc/density_check.cu CHECK_L
    _check("pos", pos, torch.float32, (n, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("t0", t0, torch.float32, (n,), dev)
    _check("t1", t1, torch.float32, (n,), dev)
    _check("ext_rmo", ext_rmo, torch.float32, (n, L, 3), dev)
    _check("table", table, torch.float32, (384, 1024, 3), dev)
    seg = torch.empty((n, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((n, L), dtype=torch.float32, device=dev)
    _launch("de_density_check", _ptr(pos), _ptr(direction), _ptr(t0), _ptr(t1), _ptr(ext_rmo),
            _ptr(table), _ptr(seg), _ptr(trans), n, L)
    return seg, trans


def _tap_mode(bilinear: bool, first_form: bool) -> int:
    """csrc/texture_check.cu's tap mode: 0 nearest, 1 bilinear, 2 the
    bilinear form texture.cuh first had."""
    if first_form and not bilinear:
        raise ValueError("first_form: the first form is a bilinear tap")
    return 2 if first_form else int(bilinear)


def sphere_tap(tex, pos, bilinear: bool, first_form: bool = False):
    """Test launcher of the kernels' sphere tap (not a path kernel): the
    (n, C) tap of a uint8 (H, W, C) texture, C 4 or 8, at the direction of
    each ``pos``, computed on the card by csrc/texture_check.cu; with
    ``first_form`` by the bilinear form texture.cuh first had (a byte read
    and a conversion a channel, two remainders), which the card holds the
    bilinear tap bit for bit against."""
    dev = pos.device
    n = pos.shape[0]
    h, w, c = tex.shape
    if c not in (4, 8):
        raise ValueError(f"sphere_tap: {c} channels, the kernel takes 4 or 8")
    if c == 4:
        _check_tex4("tex", tex, dev)
    else:
        _check_tex8("tex", tex, dev)
    _check("pos", pos, torch.float32, (n, 3), dev)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    _launch("de_sphere_tap", _ptr(tex), h, w, c, _ptr(pos), n, _tap_mode(bilinear, first_form),
            _ptr(out))
    return out


def dir_tap(tex, direction, bilinear: bool, first_form: bool = False):
    """Test launcher of the kernels' direction tap (not a path kernel): the
    (n, 3) tap of a uint8 (H, W, 3) texture (the stars) at each unit
    ``direction``, as ``frame_end`` and ``preview`` take it, computed on the
    card by csrc/texture_check.cu; ``first_form`` as ``sphere_tap``'s."""
    dev = direction.device
    n = direction.shape[0]
    h, w = tex.shape[:2]
    _check("tex", tex, torch.uint8, (h, w, 3), dev)
    _check("direction", direction, torch.float32, (n, 3), dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    _launch("de_dir_tap", _ptr(tex), h, w, 3, _ptr(direction), n,
            _tap_mode(bilinear, first_form), _ptr(out))
    return out


def _threefry_keys(keys):
    """(n, 2) keys on a CUDA device as the launchers take them: int32 words
    (an int64 batch holding uint32 values is converted, int32 passes)."""
    if keys.device.type != "cuda":
        raise ValueError(f"keys: on {keys.device}, expected a CUDA device (the threefry "
                         "launchers have no CPU mode: ops/rng.py is the plain version)")
    k32 = keys if keys.dtype == torch.int32 else keys_i32(keys)
    _check("keys", k32, torch.int32, (keys.shape[0], 2), keys.device)
    return k32


def threefry_uniform(keys, data: int, count: int):
    """Test launcher of the kernels' threefry header (not a path kernel):
    ``uniform(fold(keys, data), (count,))`` as (count, n), computed on the
    card by csrc/threefry_check.cu."""
    k32 = _threefry_keys(keys)
    n = k32.shape[0]
    out = torch.empty((count, n), dtype=torch.float32, device=keys.device)
    _launch("de_threefry_uniform", _ptr(k32), n, data & 0xFFFFFFFF, count, _ptr(out))
    return out


def threefry_draws(keys, base: int, count: int):
    """Test launcher of the header's uniform (not a path kernel): (count, n)
    draws ``uniform(key, base + j)`` (counters mod 2**32) from each key
    itself, computed on the card by csrc/threefry_check.cu;
    ``ops/rng.uniform_at`` is the plain version."""
    k32 = _threefry_keys(keys)
    n = k32.shape[0]
    out = torch.empty((count, n), dtype=torch.float32, device=keys.device)
    _launch("de_threefry_draws", _ptr(k32), n, base & 0xFFFFFFFF, count, _ptr(out))
    return out


def threefry_draw_sum(keys, base: int, count: int):
    """Test launcher of the header's uniform (not a path kernel): (n,) the
    float32 sum of ``uniform(key, base + j)`` for j < ``count`` (1 or 2),
    in order, computed on the card by csrc/threefry_check.cu (whose two
    instances give chip_smoke.py a draw's SASS instructions)."""
    if count not in (1, 2):
        raise ValueError(f"threefry_draw_sum: count {count}, the launcher has 1 and 2")
    k32 = _threefry_keys(keys)
    out = torch.empty((k32.shape[0],), dtype=torch.float32, device=keys.device)
    _launch("de_threefry_draw_sum", _ptr(k32), k32.shape[0], base & 0xFFFFFFFF, count, _ptr(out))
    return out


def fast_uniform_check(keys, counter: int, count: int):
    """Launch ``fast_uniform_check`` (csrc/fast_uniform_check.cu), the
    trackers' counter hash: (count, n) draws ``fast_uniform(key, counter,
    j)``, j < count (the counter mod 2**32); ``ops/rng.fast_uniform(keys,
    counter, (count,))`` is the plain version."""
    k32 = _threefry_keys(keys)
    n = k32.shape[0]
    out = torch.empty((count, n), dtype=torch.float32, device=keys.device)
    if n and count > 0:
        _launch("de_fast_uniform", _ptr(k32), n, counter & 0xFFFFFFFF, count, _ptr(out))
        _count(fast_uniform_check, 1)
    return out


def threefry_fold(keys, data: int, depth: int):
    """Test launcher of the header's fold (not a path kernel): (n, 2) int32
    words of ``fold`` applied ``depth`` (1 or 2) times with ``data``,
    computed on the card by csrc/threefry_check.cu."""
    if depth not in (1, 2):
        raise ValueError(f"threefry_fold: depth {depth}, the launcher has 1 and 2")
    k32 = _threefry_keys(keys)
    out = torch.empty_like(k32)
    _launch("de_threefry_fold", _ptr(k32), k32.shape[0], data & 0xFFFFFFFF, depth, _ptr(out))
    return out


def upsample(base, factor: int, jitter: float, jitter_channel: int, jitter_seed: int):
    """Launch ``upsample`` (csrc/upsample.cu): the uint8 (h, w, C) ``base``
    nearest-neighbour-upsampled to (h * factor, w * factor, C), channel
    ``jitter_channel`` scaled down by the per-texel hash jitter when
    ``jitter`` > 0 (ops/texture.upsample_plain is the twin)."""
    dev = base.device
    if dev.type != "cuda":
        raise ValueError(f"base: on {dev}, expected a CUDA device")
    if base.dim() != 3:
        raise ValueError(f"base: shape {tuple(base.shape)}, expected (h, w, C)")
    h, w, c = base.shape
    f = int(factor)
    if not 1 <= c <= 8 or f < 1:
        raise ValueError(f"upsample: {c} channels (1-8), factor {f} (>= 1)")
    _check("base", base, torch.uint8, (h, w, c), dev)
    out = torch.empty((h * f, w * f, c), dtype=torch.uint8, device=dev)
    n = h * f * w * f
    jc = jitter_channel if jitter > 0.0 and 0 <= jitter_channel < c else -1
    _launch("de_upsample", _ptr(base), w, c, f, _ptr(out), n, jc, jitter,
            jitter_seed & 0xFFFFFFFF)
    _count(upsample, 1)
    return out


# the preview kernel's parameter blocks as the wrapper takes them: eleven
# ints, then MARCH_OPTIONS (the stall patience, int 2, is a run-time
# parameter of every instance); the C entry's int
# block has one more, the instance (csrc/preview.cu)
PREVIEW_FLOATS, PREVIEW_INTS = 22, 11 + len(MARCH_OPTIONS)


def preview(fparams, iparams, key, pos, direction, wavelength, tile_index, lane_index, topo,
            material, stars, o3_crossec, srgb2spec, *, origin=None, census: bool = False,
            cert_floor: float = None, options: bool = False):
    """Launch ``preview`` (csrc/preview.cu): the (n,) preview radiance of
    each lane, the whole of ``march_paths``. ``key`` is (k0, k1): the spp key
    with ``tile_index`` (n,) int64 (the lane's tile key is fold(key, tile
    index)), or the tile key of one tile of n lanes with ``tile_index`` None;
    ``lane_index`` (n,) int64 is the in-tile index (None with ``tile_index``
    None). ``pos`` (n, 3), or None with ``origin`` (three floats) every
    lane's origin, passed by value. ``fparams`` (22 floats) and ``iparams``
    (15 ints: de_preview's first 11, then the march options
    ``MARCH_OPTIONS``) are laid out as de_preview documents
    (render/raymarcher.PreviewFrame builds them); an option off its default
    (or ``options``) runs the options instance, ``cert_floor`` (the
    uncertified floor of TraceConfig.march_certified_floor, or None) the
    floor instance, which also takes the options (counted as an options
    launch). With ``census`` the census instance (of the default) runs and
    (out, cycles) comes back, cycles (n, 3) int64 each lane's clock64 cycles
    in its land and shadow marches, in the march and in all."""
    dev = direction.device
    n = direction.shape[0]
    if len(fparams) != PREVIEW_FLOATS or len(iparams) != PREVIEW_INTS:
        raise ValueError(f"preview: expected {PREVIEW_FLOATS} float and {PREVIEW_INTS} int "
                         "parameters")
    if (tile_index is None) != (lane_index is None):
        raise ValueError("preview: pass tile_index and lane_index together")
    if (pos is None) == (origin is None):
        raise ValueError("preview: pass pos or origin, not both")
    if iparams[4] < 1 or (tile_index is None and iparams[4] != n):
        raise ValueError(f"preview: {iparams[4]} lanes per tile for {n} lanes")
    _check_march_k(iparams[1])
    if pos is not None:
        _check("pos", pos, torch.float32, (n, 3), dev)
    elif len(origin) != 3:
        raise ValueError("preview: origin takes three floats")
    _check("direction", direction, torch.float32, (n, 3), dev)
    _check("wavelength", wavelength, torch.float32, (n,), dev)
    if tile_index is not None:
        _check("tile_index", tile_index, torch.int64, (n,), dev)
        _check("lane_index", lane_index, torch.int64, (n,), dev)
    _check_tex4("topo", topo, dev)
    _check_tex8("material", material, dev)
    _check("stars", stars, torch.uint8, (*stars.shape[:2], 3), dev)
    if tuple(iparams[5:11]) != (*topo.shape[:2], *material.shape[:2], *stars.shape[:2]):
        raise ValueError("preview: texture sizes disagree with the int parameters")
    _check("o3_crossec", o3_crossec, torch.float32, (441,), dev)
    _check("srgb2spec", srgb2spec, torch.float32, (300, 3), dev)
    cert = cert_floor is not None
    opts = _options_instance(iparams, 11, MARCH_OPTIONS, options or cert)
    if census and opts:
        raise ValueError("preview: the census instance is the default instance's; the "
                         "options and floor instances have none")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    cycles = torch.empty((n, 3), dtype=torch.int64, device=dev) if census else None
    if n:
        # the C entry's blocks: the uncertified floor after the floats, the
        # certified floor's flag and the instance after the ints
        fp = (ctypes.c_float * (PREVIEW_FLOATS + 1))(*fparams, cert_floor if cert else 0.0)
        ip = (ctypes.c_int * (PREVIEW_INTS + 2))(*iparams, int(cert), int(opts))
        org = (ctypes.c_float * 3)(*origin) if origin is not None else None
        _launch(
            "de_preview", ctypes.cast(fp, ctypes.c_void_p), ctypes.cast(ip, ctypes.c_void_p),
            key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF,
            None if org is None else ctypes.cast(org, ctypes.c_void_p), _ptr_or_null(pos),
            _ptr(direction),
            _ptr(wavelength), _ptr_or_null(tile_index), _ptr_or_null(lane_index), _ptr(topo),
            _ptr(material), _ptr(stars), _ptr(o3_crossec), _ptr(srgb2spec), _ptr(out),
            _ptr_or_null(cycles), n,
        )
        _count(preview, 1, opts)
    return (out, cycles) if census else out


def _occupancy(entry, *args):
    out = (ctypes.c_int * 4)()
    rc = getattr(library(), entry)(*args, out)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    blocks, threads, regs, local = list(out)
    return dict(blocks_per_sm=blocks, threads=threads, registers=regs, local_bytes=local,
                warps_per_sm=blocks * threads // 32)


def preview_occupancy(options: int = 0):
    """The ``preview`` kernel's registers per thread, local memory and
    resident blocks and warps per SM on the current device (its default
    instance, with ``options`` 1 (or True) its options instance, with 2 its
    floor instance)."""
    return _occupancy("de_preview_occupancy", int(options))


def atmos_march_occupancy():
    """The same for the ``atmos_march`` launcher."""
    return _occupancy("de_atmos_march_occupancy")


PATH_KERNELS = (land_march, rmo_delta_track, rmo_ratio_track, cloud_track, naive_march,
                naive_delta_track, naive_ratio_track, flight_analytic, fast_uniform_check, gen_rays,
                atmos_march, film_postprocess, frame_end, select_tiles, select_tiles_shard,
                bounce_flight, bounce_shade, bounce_window, compact_lanes, upsample, preview)
# the kernels with an options instance
OPTIONS_KERNELS = (land_march, rmo_delta_track, rmo_ratio_track, cloud_track, bounce_flight,
                   bounce_shade, bounce_window, preview)
# the kernels that take a packet of L wavelengths
WIDTH_KERNELS = (rmo_ratio_track, gen_rays, frame_end, bounce_flight, bounce_shade,
                 bounce_window)


def reset_launch_counts():
    for fn in PATH_KERNELS:
        fn.launches = fn.options_launches = 0
        fn.width_launches = {}


reset_launch_counts()


def launch_counts() -> dict:
    """Each path kernel's launches (any instance), then as ``"<name>/options"``
    those of each options instance, and as ``"<name>/L<n>"`` those at each
    packet width n outside ``BOUNCE_WIDTHS`` that launched."""
    counts = {fn.__name__: fn.launches for fn in PATH_KERNELS}
    counts.update({f"{fn.__name__}/options": fn.options_launches for fn in OPTIONS_KERNELS})
    counts.update({f"{fn.__name__}/L{L}": c for fn in WIDTH_KERNELS
                   for L, c in sorted(fn.width_launches.items())})
    return counts
