"""The port's viewer path on the CPU: chunked accumulation, checkpoints, the
camera controller, PNG encoding, the frame-rate controller and
``EarthViewer`` (HTTP routes, preview escalation, key impulses, adaptive
passes), against the JAX package where it has a counterpart.

- A chunked spp against the whole one: on the card the two are bit-equal
  (chip_smoke.py checks it at 1920x1080). On the CPU, PyTorch runs Sleef on
  the body of its vector loops and scalar libm on the tail, so a lane's
  exp/log can move by an ulp with its place in the chunk; the stated
  tolerance is share >= 0.99 of pixels within 1e-4 relative, with channel
  means within 1e-4 (measured: bit-equal at the test's size).
- The viewer runs under tests/test_viewer.py's stub renderers (the same
  scenarios as its TestViewerHTTP, TestProgressiveEscalation and
  TestAdaptiveViewer) and once with a real port Renderer at 16x9. Every
  check of the render loop's progress waits for its condition with a
  deadline instead of asserting after a fixed sleep.
"""

import json
import os
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from digital_earth_tpu import constants as JC
from digital_earth_tpu.app.camera_controller import CameraController as JaxCamera
from digital_earth_tpu.utils import profiling as jprof
from digital_earth_tpu_torch import __main__ as entry
from digital_earth_tpu_torch.app.camera_controller import CameraController
from digital_earth_tpu_torch.app.config_io import apply_config, load_config
from digital_earth_tpu_torch.app.viewer import EarthViewer, encode_png, render_offline, upscale_u8
from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.render.params import TraceConfig
from digital_earth_tpu_torch.render.renderer import Renderer
from digital_earth_tpu_torch.utils import profiling
from test_viewer import AdaptiveStubRenderer, StubRenderer

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APOLLO = os.path.join(ROOT, "scenes", "config - Apollo 11.txt")
SMALL = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256)


@pytest.fixture(scope="module")
def atlas():
    return build_atlas(generate_earth_textures((64, 128), seed=3), "cpu")


def _mk(atlas, mode="path", res=(32, 16), seed=7, tile_pixels=64):
    r = Renderer("cpu", image_res=res, atlas=atlas, tile_pixels=tile_pixels, seed=seed,
                 cfg=SMALL, mode=mode)
    apply_config(r, load_config(APOLLO))
    return r


# --- chunked accumulation (ports of test_renderer.py:95-124) -----------------


@pytest.mark.parametrize("mode", ["path", "preview"])
def test_chunked_spp_matches_whole(atlas, mode):
    a, b = _mk(atlas, mode), _mk(atlas, mode)
    a.accumulate()
    assert b.accumulate_interruptible(4, interrupt=lambda: False)
    assert (b.current_spp, b._rng_round, b.total_samples) == (1, 1, 32 * 16)
    got, want = b.color_buffer.numpy(), a.color_buffer.numpy()
    # measured: bit-equal in both modes at this size (4 chunks of 128 lanes)
    share = np.isclose(got, want, rtol=1e-4, atol=1e-9).all(-1).mean()
    assert share >= 0.99, share
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=1e-4)


@pytest.mark.parametrize("mode", ["path", "preview"])
def test_chunked_abort_discards_partial_spp(atlas, mode):
    r = _mk(atlas, mode)
    calls = []

    def interrupt():
        calls.append(1)
        return True  # abort at the first poll

    assert not r.accumulate_interruptible(4, interrupt=interrupt)
    assert len(calls) == 1
    assert (r.current_spp, r._rng_round, r.total_samples) == (0, 0, 0)
    assert not r.color_buffer.any()


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_path_spp_aborts_between_bounces(atlas, n_chunks):
    """The path tracer polls before each bounce, so even a one-chunk spp
    answers input within a bounce; the partial spp is discarded."""
    r = _mk(atlas)
    calls = []

    def interrupt():
        calls.append(1)
        return len(calls) == 2  # before bounce 1 of the first chunk

    assert not r.accumulate_interruptible(n_chunks, interrupt=interrupt)
    assert len(calls) == 2
    assert (r.current_spp, r._rng_round, r.total_samples) == (0, 0, 0)
    assert not r.color_buffer.any()
    r.accumulate()
    assert r.current_spp == 1 and r.color_buffer.any()


# --- checkpoints -------------------------------------------------------------


def test_checkpoint_round_trip(atlas, tmp_path):
    r = _mk(atlas, res=(16, 8))
    r.accumulate()
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    r2 = _mk(atlas, res=(16, 8), seed=99)
    r2.load_checkpoint(path)
    assert (r2.current_spp, r2._rng_round, r2.total_samples, r2._seed_key) == (
        1, 1, 128, (0, 7))
    assert r2.mean_spp == 1.0
    assert torch.equal(r2.color_buffer, r.color_buffer)
    r.accumulate()
    r2.accumulate()  # resumes as if uninterrupted
    assert torch.equal(r2.color_buffer, r.color_buffer)


def test_checkpoint_with_adaptive_counts_loads(atlas, tmp_path):
    path = str(tmp_path / "adaptive.npz")
    counts = np.arange(128, dtype=np.float32).reshape(16, 8) % 3 + 1
    np.savez_compressed(path, color_buffer=np.ones((16, 8, 3), np.float32), current_spp=2,
                        seed_key=np.array([0, 7], np.uint32), rng_round=3, adaptive_rounds=3,
                        total_samples=int(counts.sum()), count_buffer=counts,
                        lum2_buffer=np.full((16, 8), 0.5, np.float32))
    r = _mk(atlas, res=(16, 8))
    r.load_checkpoint(path)
    assert (r.current_spp, r._rng_round, r._adaptive_rounds) == (2, 3, 3)
    assert r.count_buffer.dtype == torch.float32
    np.testing.assert_array_equal(r.count_buffer.numpy(), counts)
    assert r.mean_spp == pytest.approx(counts.mean())
    with pytest.raises(ValueError, match="adaptive"):
        r.accumulate_interruptible(1)
    assert r.accumulate_adaptive(frac=0.25)
    assert r.count_buffer.sum().item() == counts.sum() + r.tile * max(
        1, int((16 // r.block[0]) * (8 // r.block[1]) * 0.25))


# --- the camera controller against the JAX class (test_app.py:59-105) -------

R3 = JC.PLANET_R * 3
SEQUENCES = {
    "wasd": ((0.0, 0.0, R3), [({"w"}, 0.1), ({"a", "space"}, 0.2), ({"s", "d"}, 0.05)], []),
    "near_surface": ((0.0, 0.0, JC.PLANET_R + 10000.0), [({"w"}, 0.1), ({"ctrl"}, 0.3)], []),
    "cannot_enter": ((0.0, 0.0, JC.PLANET_R + 1000.0), [({"w", "shift"}, 1.0)] * 50, []),
    "q_e_up": ((0.0, 0.0, JC.PLANET_R * 2), [({"q"}, 0.1), ({"w", "e"}, 0.1), ({"q", "d"}, 0.2)], []),
    "drag": ((0.0, 0.0, 3e7), [], [(0.05, 0.02), (-0.2, 0.1), (0.0, -0.3)]),
    "mixed": ((-1.5e7, 2e6, 1.5e7), [({"w", "shift"}, 0.1), ({"a"}, 0.1)], [(0.1, -0.05)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_camera_controller_matches_jax(name):
    start, key_frames, drags = SEQUENCES[name]
    port, ref = CameraController(position=start, look_at=(0, 0, 0)), JaxCamera(
        position=start, look_at=(0, 0, 0))
    for keys, dt in key_frames:
        assert port.update_keys(keys, dt) == ref.update_keys(keys, dt)
    for dx, dy in drags:
        assert port.rotate(dx, dy) == ref.rotate(dx, dy)
    for attr in ("position", "look_at", "up"):
        np.testing.assert_array_equal(getattr(port, attr), getattr(ref, attr))
    assert np.linalg.norm(port.position) >= JC.PLANET_R


# --- PNG, upscale, entry point ------------------------------------------------


def _decode_png(png):
    """(width, height, (H, W, 3) pixels) of an 8-bit RGB, filter-0 PNG."""
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert png[12:16] == b"IHDR"
    w, h, depth, ctype = struct.unpack(">IIBB", png[16:26])
    assert (depth, ctype) == (8, 2)
    idat = png.index(b"IDAT")
    n = struct.unpack(">I", png[idat - 4:idat])[0]
    raw = np.frombuffer(zlib.decompress(png[idat + 4:idat + 4 + n]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return w, h, rows[:, 1:].reshape(h, w, 3)


def test_encode_png_round_trip():
    img = np.random.default_rng(0).integers(0, 256, (9, 16, 3), dtype=np.uint8)
    w, h, pixels = _decode_png(encode_png(img))
    assert (w, h) == (16, 9)
    np.testing.assert_array_equal(pixels, img)


def test_upscale_keeps_flat_images_flat():
    img = torch.full((5, 8, 3), 77, dtype=torch.uint8)
    big = upscale_u8(img, (18, 32))
    assert big.shape == (18, 32, 3) and big.dtype == torch.uint8
    assert (big == 77).all()


def test_render_offline_preview_writes_png(atlas, tmp_path):
    out = tmp_path / "preview.png"
    r = render_offline(load_config(APOLLO), "cpu", spp=1, image_res=(16, 9),
                       out_path=str(out), atlas=atlas, cfg=SMALL, mode="preview")
    assert r.mode == "preview" and r.color_buffer.any()
    assert _decode_png(out.read_bytes())[:2] == (16, 9)


def test_entry_point_multichip_serves_a_mesh_renderer(monkeypatch, tmp_path):
    """``--multichip`` hands EarthViewer a MultiChipRenderer over every CUDA
    card (here the mesh over one CPU device, a small atlas and no server)."""
    from digital_earth_tpu_torch.parallel import mesh as mesh_mod
    from digital_earth_tpu_torch.render import renderer as renderer_mod

    started = []
    make_mesh = mesh_mod.make_render_mesh
    small = build_atlas(generate_earth_textures((16, 32), seed=3), "cpu")
    monkeypatch.chdir(tmp_path)  # the viewer's config.txt and screenshot/
    monkeypatch.setattr(mesh_mod, "make_render_mesh", lambda: make_mesh(["cpu"]))
    monkeypatch.setattr(renderer_mod, "load_texture_atlas", lambda device: small)
    monkeypatch.setattr(EarthViewer, "start", lambda self: started.append(self))
    assert entry.main(["--multichip", "--adaptive", "--port", "8124"]) == 0
    (v,) = started
    r = v.renderer
    assert isinstance(r, mesh_mod.MultiChipRenderer) and r.atlas is small
    assert r.image_res == (1920, 1080) and r.mesh.shape == {"px": 1, "spp": 1}
    assert (v.port, v.adaptive_frac) == (8124, 0.25)
    assert v.preview_renderer.image_res == (480, 270) and v.preview_renderer.atlas is small


def test_entry_point_adaptive_starts_an_adaptive_viewer(monkeypatch):
    from digital_earth_tpu_torch.app import viewer as viewer_mod

    made = []

    class Recorder:
        def __init__(self, **kwargs):
            made.append(kwargs)

        def start(self):
            made.append("started")

    monkeypatch.setattr(viewer_mod, "EarthViewer", Recorder)
    assert entry.main(["--adaptive", "--port", "8123"]) == 0
    assert made == [dict(device="cuda", image_res=(1920, 1080), port=8123,
                         adaptive_frac=0.25), "started"]


def test_viewer_needs_a_renderer_or_a_device():
    with pytest.raises(ValueError, match="device"):
        EarthViewer(renderer=None)


def test_viewer_accepts_adaptive_frac(tmp_path):
    v = EarthViewer(renderer=AdaptiveStubRenderer(), adaptive_frac=0.25, adaptive_fps=5.0,
                    spp_chunks=4, config_path=str(tmp_path / "config.txt"),
                    screenshot_dir=str(tmp_path / "shots"), port=0)
    assert (v.adaptive_frac, v.adaptive_fps, v.spp_chunks) == (0.25, 5.0, 1)


# --- the frame-rate controller against the JAX classes -----------------------


@pytest.mark.parametrize("target_fps,max_spp", [(20.0, 6), (2.0, 64)])
def test_adaptive_spp_matches_jax(target_fps, max_spp):
    """AdaptiveSpp on a scripted sequence of frame times, step for step."""
    elapsed = [0.01, 0.02, 0.5, 0.03, 0.2, 0.001, 1.5, 0.04, 0.04, 0.3, 0.7, 0.05]
    port = profiling.AdaptiveSpp(target_fps=target_fps, max_spp=max_spp)
    ref = jprof.AdaptiveSpp(target_fps=target_fps, max_spp=max_spp)
    assert [port.update(e) for e in elapsed] == [ref.update(e) for e in elapsed]


# --- EarthViewer over HTTP ----------------------------------------------------


def _serve(v):
    v._running = True
    loop = threading.Thread(target=v._render_loop, daemon=True)
    loop.start()
    server = v.make_server(host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    v._test_port = server.server_address[1]
    return loop, server


def _stop(v, loop, server):
    v._running = False
    server.shutdown()
    server.server_close()
    loop.join(timeout=30)
    assert not loop.is_alive()


def _get(v, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{v._test_port}{path}", timeout=30) as r:
        return r.read()


class PortStub(StubRenderer):
    """The uniform stub with the port's surface: ``total_samples`` and an
    abortable spp that polls the interrupt once."""

    def __init__(self, image_res=(16, 9)):
        super().__init__(image_res)
        self.total_samples = 0

    def accumulate_interruptible(self, n_chunks, interrupt=None):
        if interrupt is not None and interrupt():
            return False
        self.accumulate()
        self.total_samples += self.image_res[0] * self.image_res[1]
        return True


@pytest.fixture()
def viewer(tmp_path):
    v = EarthViewer(renderer=PortStub(), config_path=str(tmp_path / "config.txt"),
                    screenshot_dir=str(tmp_path / "shots"), port=0)
    loop, server = _serve(v)
    yield v
    _stop(v, loop, server)


@pytest.fixture()
def esc_viewer(tmp_path):
    v = EarthViewer(renderer=PortStub(image_res=(32, 18)),
                    config_path=str(tmp_path / "config.txt"),
                    screenshot_dir=str(tmp_path / "shots"), port=0)
    v.preview_renderer = StubRenderer(image_res=(8, 5))
    loop, server = _serve(v)
    yield v
    _stop(v, loop, server)


def _wait(pred, limit=10.0):
    """Poll ``pred`` until it holds or ``limit`` seconds pass; its last value."""
    deadline = time.time() + limit
    while not pred() and time.time() < deadline:
        time.sleep(0.01)
    return pred()


def test_viewer_state_reports_accumulation(viewer):
    assert _wait(lambda: json.loads(_get(viewer, "/state"))["spp"] > 0)
    state = json.loads(_get(viewer, "/state"))
    assert state["spp"] > 0 and state["crf_name"] == "Neutral" and state["error"] is None


def test_viewer_slider_resets_but_exposure_does_not(viewer):
    time.sleep(0.05)
    r0 = viewer.renderer.resets
    _get(viewer, "/set?sun_angle=120")
    assert viewer.renderer.resets > r0
    assert viewer.renderer.sun_angle == pytest.approx(np.radians(120.0))
    r1 = viewer.renderer.resets
    _get(viewer, "/set?exposure=4.5")
    assert viewer.renderer.exposure == 4.5 and viewer.renderer.resets == r1


def test_viewer_keys_move_the_camera(viewer):
    p0 = viewer.camera.position.copy()
    _get(viewer, "/input?keys=w")
    assert _wait(lambda: not np.array_equal(viewer.camera.position, p0))
    _get(viewer, "/input?keys=")


def test_viewer_save_load_and_screenshot(viewer):
    _get(viewer, "/set?sun_angle=77")
    _get(viewer, "/save")
    _get(viewer, "/set?sun_angle=10")
    _get(viewer, "/load")
    assert viewer.renderer.sun_angle == pytest.approx(np.radians(77.0), rel=1e-5)
    path = _get(viewer, "/screenshot").decode()
    with open(path, "rb") as f:
        assert _decode_png(f.read())[:2] == (16, 9)


def test_viewer_bad_requests(viewer):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(viewer, "/set?exposure=banana")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(viewer, "/nonexistent")
    assert e.value.code == 404
    assert b"<html>" in _get(viewer, "/")


def test_viewer_idle_frames_are_path_traced(esc_viewer):
    assert _wait(lambda: esc_viewer._frame_source == "path"
                 and esc_viewer.renderer.current_spp > 0)


def test_viewer_scene_change_previews_then_escalates(esc_viewer):
    time.sleep(0.2)
    p0 = esc_viewer.preview_renderer.resets
    _get(esc_viewer, "/set?sun_angle=12")
    _wait(lambda: esc_viewer.preview_renderer.resets > p0)
    assert esc_viewer.preview_renderer.resets > p0
    assert esc_viewer.preview_renderer.sun_angle == pytest.approx(esc_viewer.renderer.sun_angle)
    assert _wait(lambda: esc_viewer._frame_source == "path")


def test_viewer_key_impulse_ends_motion(esc_viewer):
    time.sleep(0.3)
    _get(esc_viewer, "/input?keys=w")
    _wait(lambda: esc_viewer._frame_source == "preview")
    _wait(lambda: esc_viewer._frame_source == "path")
    assert esc_viewer._frame_source == "path"
    assert not esc_viewer._pending_keys


def test_viewer_preview_png_upscales_to_full_res(esc_viewer):
    esc_viewer._frame_source = "preview"
    esc_viewer._snapshot_frame()
    assert _decode_png(esc_viewer._frame_png())[:2] == (32, 18)


def test_viewer_with_a_port_renderer(atlas, tmp_path):
    """A real port Renderer at 16x9: a preview frame first, then path spp in
    chunks, a PNG of the full size, and a preview again after a key."""
    config = tmp_path / "config.txt"
    config.write_text(open(APOLLO).read())
    r = Renderer("cpu", image_res=(16, 9), atlas=atlas, cfg=SMALL)
    v = EarthViewer(renderer=r, config_path=str(config), screenshot_dir=str(tmp_path / "shots"),
                    port=0, spp_chunks=3)
    assert v.preview_renderer.mode == "preview" and v.preview_renderer.image_res == (32, 18)
    loop, server = _serve(v)
    try:
        sources, deadline = set(), time.time() + 120
        while time.time() < deadline:
            s = json.loads(_get(v, "/state"))
            sources.add(s["frame_source"])
            if s["frame_source"] == "path" and s["spp"] >= 1:
                break
            time.sleep(0.05)
        assert s["error"] is None and s["spp"] >= 1 and sources == {"preview", "path"}, s
        assert _decode_png(_get(v, "/frame.png"))[:2] == (16, 9)
        frames = s["frames"]
        _get(v, "/input?keys=w")
        deadline = time.time() + 120
        while time.time() < deadline:
            s = json.loads(_get(v, "/state"))
            if s["frame_source"] == "preview" and s["frames"] > frames:
                break
            time.sleep(0.02)
        assert s["frame_source"] == "preview" and s["frames"] > frames, s
    finally:
        _stop(v, loop, server)


# --- adaptive passes in the viewer (test_viewer.py:224-283) --------------------


class PortAdaptiveStub(AdaptiveStubRenderer):
    """The adaptive stub with the port's interrupt poll between bounces."""

    def __init__(self, image_res=(16, 9)):
        super().__init__(image_res)
        self.polls = 0

    def accumulate_adaptive(self, frac=0.25, min_warmup=2, interrupt=None):
        if interrupt is not None:
            self.polls += 1
            if interrupt():
                return False
        super().accumulate_adaptive(frac, min_warmup)
        return True


@pytest.fixture()
def ada_viewer(tmp_path):
    v = EarthViewer(renderer=PortAdaptiveStub(), config_path=str(tmp_path / "config.txt"),
                    screenshot_dir=str(tmp_path / "shots"), port=0, adaptive_frac=0.25)
    loop, server = _serve(v)
    yield v
    _stop(v, loop, server)


def test_adaptive_viewer_idle_frames_are_adaptive_passes(ada_viewer):
    assert _wait(lambda: ada_viewer.renderer.adaptive_calls > 2)
    assert ada_viewer.spp_chunks == 1
    assert ada_viewer.renderer.polls >= ada_viewer.renderer.adaptive_calls


def test_adaptive_viewer_state_reports_mean_spp(ada_viewer):
    r = ada_viewer.renderer
    assert _wait(lambda: json.loads(_get(ada_viewer, "/state"))["paths_per_sec"] > 0)
    assert _wait(lambda: r.adaptive_calls >= 3)
    # the render loop keeps accumulating around the request: the reply lies
    # between the mean read just before it and just after it (to its
    # 2-decimal rounding)
    before = r.mean_spp
    s = json.loads(_get(ada_viewer, "/state"))
    after, passes = r.mean_spp, r.current_spp
    assert round(before, 2) <= s["spp"] <= round(after, 2)
    # the mean samples per pixel (a quarter of the pixels per pass), not the
    # pass count
    assert s["spp"] < passes


def test_adaptive_fps_sets_the_passes_per_frame(tmp_path):
    class SlowStub(PortAdaptiveStub):
        def accumulate_adaptive(self, frac=0.25, min_warmup=2, interrupt=None):
            time.sleep(0.004)
            return super().accumulate_adaptive(frac, min_warmup, interrupt)

    v = EarthViewer(renderer=SlowStub(), config_path=str(tmp_path / "config.txt"),
                    screenshot_dir=str(tmp_path / "shots"), port=0, adaptive_frac=0.25,
                    adaptive_fps=10.0)
    seen = []
    original = v._accumulate_idle

    def record(spp_per_frame):
        seen.append(spp_per_frame)
        return original(spp_per_frame)

    v._accumulate_idle = record
    loop, server = _serve(v)
    try:
        # a 0.1 s frame budget and ~5 ms passes: the controller adds a pass
        # per frame, so frames come to hold several
        assert _wait(lambda: max(seen, default=1) >= 3), seen
    finally:
        _stop(v, loop, server)
    assert seen[0] == 1


def test_adaptive_viewer_with_a_port_renderer(atlas, tmp_path):
    """A real port Renderer at 16x9 under adaptive_frac: after the uniform
    warm-up the mean spp goes fractional, and input gets a preview frame."""
    config = tmp_path / "config.txt"
    config.write_text(open(APOLLO).read())
    r = Renderer("cpu", image_res=(16, 9), atlas=atlas, cfg=SMALL, tile_pixels=16)
    v = EarthViewer(renderer=r, config_path=str(config), screenshot_dir=str(tmp_path / "shots"),
                    port=0, adaptive_frac=0.25)
    loop, server = _serve(v)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            s = json.loads(_get(v, "/state"))
            if s["frame_source"] == "path" and s["spp"] > 2:
                break
            time.sleep(0.05)
        assert s["error"] is None and s["spp"] > 2 and s["spp"] != int(s["spp"]), s
        assert r._adaptive_rounds >= 3 and r.count_buffer.min().item() >= 2
        frames = s["frames"]
        _get(v, "/input?keys=w")
        deadline = time.time() + 120
        while time.time() < deadline:
            s = json.loads(_get(v, "/state"))
            if s["frame_source"] == "preview" and s["frames"] > frames:
                break
            time.sleep(0.02)
        assert s["frame_source"] == "preview" and s["frames"] > frames, s
    finally:
        _stop(v, loop, server)
