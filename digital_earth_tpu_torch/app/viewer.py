"""Interactive progressive viewer and scripted rendering (port of
digital_earth_tpu/app/viewer.py).

A render loop accumulates progressively on the device; a small built-in web
page shows the frame, forwards WASD/QE/drag camera input and exposes the
GUI controls (sun angle/path, FOV, aspect scale, exposure, camera response,
gamma) plus config save/load ('i'/'o') and screenshots ('p'). While the
camera moves, frames come from the preview raymarcher at a fraction of the
resolution; once input stops they escalate to the path tracer, one spp at
a time, polling for input between bounces: new input abandons the partial
spp and gets a preview frame. With ``adaptive_frac`` each idle frame is an
adaptive pass over the noisiest tiles instead (Renderer.accumulate_adaptive).

Needs nothing beyond the standard library, numpy and torch: PNG frames are
encoded with ``zlib``, and the preview is upscaled on the device.

Also provides ``render_offline`` for scripted, windowless rendering.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
import torch.nn.functional as F

from ..render.renderer import Renderer
from ..utils.profiling import AdaptiveSpp
from .camera_controller import CameraController
from .config_io import SceneConfig, apply_config, load_config, save_config, snapshot_config

HELP_MSG = """
====================================================
Camera:
* Drag on the image to rotate
* Press W/A/S/D/Q/E (+Shift, Space, Ctrl) to move
* I saves config.txt, O loads it, P takes a screenshot
====================================================
"""

_PAGE = """<!doctype html>
<html><head><title>Digital Earth (CUDA)</title><style>
body { background:#111; color:#ccc; font-family:monospace; margin:12px; }
#frame { image-rendering:auto; cursor:crosshair; max-width:100%; }
.row { margin:4px 0; } input[type=range] { width: 260px; vertical-align:middle; }
span.val { display:inline-block; width:70px; }
</style></head><body>
<div><img id="frame" src="/frame.png" draggable="false"></div>
<div id="status"></div>
<div class="row">Sun angle <input type="range" id="sun_angle" min="0" max="360" step="0.1"><span class="val"></span></div>
<div class="row">Sun path <input type="range" id="sun_path_rot" min="-105" max="105" step="0.1"><span class="val"></span></div>
<div class="row">FOV <input type="range" id="fov" min="1" max="90" step="0.1"><span class="val"></span></div>
<div class="row">Aspect <input type="range" id="aspect_scale" min="0.75" max="1.25" step="0.005"><span class="val"></span></div>
<div class="row">Exposure <input type="range" id="exposure" min="-1" max="10" step="0.05"><span class="val"></span></div>
<div class="row">CRF <input type="range" id="crf" min="0" max="15" step="1"><span class="val"></span></div>
<div class="row">Gamma <input type="range" id="gamma" min="0.45" max="2.2" step="0.01"><span class="val"></span></div>
<script>
const img = document.getElementById('frame');
let keys = new Set(); let drag = null;
function refresh() { img.src = '/frame.png?' + Date.now(); }
img.onload = () => setTimeout(refresh, 250);
img.onerror = () => setTimeout(refresh, 1000);
setInterval(async () => {
  if (keys.size) await fetch('/input?keys=' + [...keys].join(','));
  const s = await (await fetch('/state')).json();
  document.getElementById('status').textContent =
    `spp ${s.spp}  |  ${s.paths_per_sec.toExponential(2)} paths/s  |  ${s.crf_name}`;
}, 200);
window.addEventListener('keydown', e => { keys.add(e.key === ' ' ? 'space' : e.key.toLowerCase());
  if (e.key==='i') fetch('/save'); if (e.key==='o') fetch('/load'); if (e.key==='p') fetch('/screenshot'); });
window.addEventListener('keyup', e => keys.delete(e.key === ' ' ? 'space' : e.key.toLowerCase()));
img.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => { if (!drag) return;
  const dx = (drag[0]-e.clientX)/img.width, dy = (drag[1]-e.clientY)/img.height;
  drag = [e.clientX, e.clientY];
  if (dx||dy) fetch(`/input?dx=${dx}&dy=${dy}`); });
for (const id of ['sun_angle','sun_path_rot','fov','aspect_scale','exposure','crf','gamma']) {
  const el = document.getElementById(id);
  el.addEventListener('input', () => { el.nextElementSibling.textContent = el.value;
    fetch(`/set?${id}=${el.value}`); });
}
fetch('/state').then(r => r.json()).then(s => {
  for (const [k, v] of Object.entries(s.sliders)) {
    const el = document.getElementById(k);
    if (el) { el.value = v; el.nextElementSibling.textContent = (+v).toFixed(2); }
  }
});
</script></body></html>"""


def encode_png(rgb: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0, zlib ``level``)."""
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), dtype=np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def upscale_u8(img, size):
    """Bilinear resize of an (h, w, 3) uint8 tensor to ``size`` = (H, W), on
    the tensor's device."""
    x = img.permute(2, 0, 1)[None].to(torch.float32)
    y = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
    return torch.clamp(y[0].permute(1, 2, 0) + 0.5, 0.0, 255.0).to(torch.uint8)


def _image_u8(renderer):
    """A renderer's display image as an (H, W, 3) uint8 tensor."""
    if hasattr(renderer, "fetch_image_u8"):
        return renderer.fetch_image_u8()
    return torch.from_numpy(np.ascontiguousarray(renderer.fetch_image_np()))


class EarthViewer:
    """Progressive interactive viewer (reference EarthViewer,
    earth_viewer.py:166-319)."""

    def __init__(
        self,
        renderer=None,
        device=None,
        image_res=(1920, 1080),
        config_path: str = "config.txt",
        screenshot_dir: str = "screenshot",
        port: int = 8000,
        preview_scale: int = 4,
        spp_chunks: int = 1,
        adaptive_frac: float = 0.0,
        adaptive_fps: float = 0.0,
        **renderer_kwargs,
    ):
        """Without ``renderer``, builds ``Renderer(device, image_res, ...)``.

        ``preview_scale`` > 0: while the camera moves (and for the first
        frame after any scene change) the loop renders the preview
        raymarcher at ``image_res / preview_scale`` (a ``Renderer`` in
        ``mode="preview"`` on the same device), upscaled on the device; once
        input goes idle, frames escalate to the path tracer. 0 disables.

        ``spp_chunks``: cut each path-traced spp into this many pixel
        ranges (``accumulate_interruptible``). The spp polls for camera
        input between bounces whatever the count, so chunks do not shorten
        the wait for input; on the card each chunk pays the whole bounce
        loop's launches, so more chunks only slow convergence (PERF.md).

        ``adaptive_frac`` > 0: each idle frame is one adaptive pass
        (``accumulate_adaptive(adaptive_frac)``, polling for input between
        bounces) that samples the noisiest ``adaptive_frac`` of the tiles
        after a uniform warm-up; ``/state`` reports the mean samples per
        pixel. Per-pixel counts are not tracked by chunks, so ``spp_chunks``
        is 1.

        ``adaptive_fps`` > 0: the samples (or passes) per idle frame follow
        ``utils.profiling.AdaptiveSpp`` toward that frame rate."""
        if renderer is None:
            if device is None:
                raise ValueError("EarthViewer needs a renderer or an explicit device")
            renderer = Renderer(device, image_res=image_res, **renderer_kwargs)
        self.renderer = renderer
        self.preview_renderer = None
        # (stub renderers in tests lack atlas/luts: escalation needs a real one)
        if preview_scale and hasattr(renderer, "atlas"):
            w, h = self.renderer.image_res
            pw, ph = max(w // preview_scale, 32), max(h // preview_scale, 18)
            self.preview_renderer = Renderer(
                renderer.device, image_res=(pw, ph), atlas=renderer.atlas,
                luts=renderer.luts, crf=renderer.crf, cfg=renderer.cfg,
                mode="preview",
            )
        self.camera = CameraController()
        self.config_path = config_path
        self.screenshot_dir = screenshot_dir
        self.port = port
        self.adaptive_frac = adaptive_frac
        self.adaptive_fps = adaptive_fps
        self.spp_chunks = 1 if adaptive_frac > 0 else spp_chunks
        self._lock = threading.Lock()
        # serializes accumulate() against frame fetches and scene changes
        self._render_lock = threading.Lock()
        self._pending_keys = set()
        self._pending_rot = [0.0, 0.0]
        self._paths_per_sec = 0.0
        self._running = False
        self.error = None
        # progressive escalation state: "preview" until the path tracer has
        # its first spp for the current pose, then "path"
        self._frame_source = "preview" if preview_scale else "path"
        self._frame_time = 0.0
        self._scene_dirty = True
        # (frame, stamp) assigned as one tuple so readers on other threads
        # never pair a new stamp with the previous frame
        self._frame_snap = (None, 0)
        self._png_cache = None
        self._png_stamp = -1
        self.camera.push_to(self.renderer)
        os.makedirs(screenshot_dir, exist_ok=True)
        if os.path.exists(config_path):
            self.load(config_path)

    # --- actions ----------------------------------------------------------
    def save(self, path=None):
        save_config(path or self.config_path, snapshot_config(self.renderer, self.camera))

    def load(self, path=None):
        cfg = load_config(path or self.config_path)
        self.camera.set_pose(cfg.camera_pos, cfg.look_at, cfg.up)
        apply_config(self.renderer, cfg)
        self.camera.push_to(self.renderer)

    def screenshot(self):
        ts = datetime.today().strftime("%Y-%m-%d-%H%M%S")
        fname = os.path.join(self.screenshot_dir, f"earth-{ts}.png")
        with self._render_lock:
            img = self.renderer.fetch_image_np()
        with open(fname, "wb") as f:
            f.write(encode_png(img))
        print(f"Screenshot has been saved to {fname}")
        return fname

    def _sync_preview_state(self):
        """Mirror scene/postprocess scalars onto the preview renderer."""
        p, r = self.preview_renderer, self.renderer
        p.sun_angle = r.sun_angle
        p.sun_path_rot = r.sun_path_rot
        p.fov = r.fov
        p.aspect_scale = r.aspect_scale
        p.land_height_scale = r.land_height_scale
        p.exposure = r.exposure
        p.gamma = r.gamma
        p.selected_crf = r.selected_crf

    def _snapshot_frame(self):
        """Cache the current frame as an (H, W, 3) uint8 array (called by the
        render loop while it holds the render lock), so /frame.png never
        waits behind an accumulate."""
        if self._frame_source == "preview" and self.preview_renderer:
            w, h = self.renderer.image_res
            frame = upscale_u8(_image_u8(self.preview_renderer), (h, w))
        else:
            frame = _image_u8(self.renderer)
        self._frame_snap = (frame.cpu().numpy(), self._frame_snap[1] + 1)

    def _frame_png(self) -> bytes:
        if self._frame_snap[0] is None:
            with self._render_lock:
                self._snapshot_frame()
        frame, stamp = self._frame_snap  # single atomic tuple read
        if self._png_cache is None or self._png_stamp != stamp:
            self._png_cache, self._png_stamp = encode_png(frame), stamp
        return self._png_cache

    def _state(self) -> dict:
        r = self.renderer
        spp = r.current_spp
        if self.adaptive_frac > 0 and r.count_buffer is not None:
            spp = round(r.mean_spp, 2)  # average samples per pixel
        return {
            "spp": spp,
            "paths_per_sec": self._paths_per_sec,
            "frame_source": self._frame_source,
            "frame_time": round(self._frame_time, 3),
            "frames": self._frame_snap[1],
            "error": self.error,
            "crf_name": r.crf_names[r.selected_crf],
            "sliders": {
                "sun_angle": np.degrees(r.sun_angle),
                "sun_path_rot": np.degrees(r.sun_path_rot),
                "fov": np.degrees(r.fov) * 2,
                "aspect_scale": r.aspect_scale,
                "exposure": r.exposure,
                "crf": r.selected_crf,
                "gamma": r.gamma,
            },
        }

    def _apply_set(self, q: dict) -> bool:
        r = self.renderer
        reset = False
        if "sun_angle" in q:
            r.set_sun_angle(np.radians(float(q["sun_angle"][0]))); reset = True
        if "sun_path_rot" in q:
            r.set_sun_path_rot(np.radians(float(q["sun_path_rot"][0]))); reset = True
        if "fov" in q:
            r.set_fov(np.radians(float(q["fov"][0])) / 2); reset = True
        if "aspect_scale" in q:
            r.set_aspect_scale(float(q["aspect_scale"][0])); reset = True
        if "exposure" in q:
            r.set_exposure(float(q["exposure"][0]))
        if "crf" in q:
            # clamp: an out-of-range index would break every later /state
            r.set_crf(max(0, min(int(q["crf"][0]), len(r.crf_names) - 1)))
        if "gamma" in q:
            r.set_gamma(float(q["gamma"][0]))
        return reset

    # --- render loop -----------------------------------------------------
    @staticmethod
    def _sync(buf):
        """Wait until the device has written ``buf``, polling a CUDA event
        with short sleeps so that the HTTP threads keep the GIL meanwhile."""
        if isinstance(buf, torch.Tensor) and buf.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(buf.device))
            while not done.query():
                time.sleep(0.002)

    def _input_pending(self) -> bool:
        with self._lock:
            return bool(self._pending_keys) or (
                self._pending_rot[0] != 0.0 or self._pending_rot[1] != 0.0
            ) or self._scene_dirty

    def _render_loop(self):
        try:
            self._loop()
        except Exception as e:
            self.error = repr(e)
            raise

    def _accumulate_idle(self, spp_per_frame: int) -> bool:
        """The idle frame's path-traced samples; False when input abandoned
        a partial spp or pass (nothing of it was kept)."""
        r = self.renderer
        for _ in range(spp_per_frame):
            if self.adaptive_frac > 0:
                done = r.accumulate_adaptive(frac=self.adaptive_frac,
                                             interrupt=self._input_pending)
            else:
                done = r.accumulate_interruptible(self.spp_chunks,
                                                  interrupt=self._input_pending)
            if not done:
                return False
            if self._input_pending():
                break  # the samples landed; answer the input now
        return True

    def _loop(self):
        controller = AdaptiveSpp(target_fps=self.adaptive_fps) if self.adaptive_fps > 0 else None
        spp_per_frame = 1
        elapsed = 0.05
        while self._running:
            with self._lock:
                keys = set(self._pending_keys)
                # consume the impulse: the web client re-sends held keys
                # every 200 ms, so clearing here ends motion on release
                self._pending_keys = set()
                dx, dy = self._pending_rot
                self._pending_rot = [0.0, 0.0]
            moved = self.camera.update_keys(keys, elapsed)
            moved = self.camera.rotate(dx, dy) or moved
            t0 = time.time()
            with self._render_lock:
                if moved:
                    self.camera.push_to(self.renderer)
                    self.renderer.reset_framebuffer()
                dirty = moved or self._scene_dirty
                self._scene_dirty = False
                # a moving camera / changed scene gets a preview frame
                # instead of queueing behind a full path-traced spp
                if dirty and self.preview_renderer is not None:
                    self.camera.push_to(self.preview_renderer)
                    self._sync_preview_state()
                    self.preview_renderer.reset_framebuffer()
                    self.preview_renderer.accumulate()
                    self._sync(self.preview_renderer.color_buffer)
                    self._frame_source = "preview"
                    self._snapshot_frame()
                    elapsed = max(time.time() - t0, 1e-4)
                    self._frame_time = elapsed
                    pw, ph = self.preview_renderer.image_res
                    self._paths_per_sec = pw * ph / elapsed
                    continue
                # on input, abandon the partial spp so the preview branch
                # answers within one bounce
                samples0 = self.renderer.total_samples
                if not self._accumulate_idle(spp_per_frame):
                    continue
                self._sync(self.renderer.color_buffer)
                self._frame_source = "path"
                self._snapshot_frame()
            elapsed = max(time.time() - t0, 1e-4)
            self._frame_time = elapsed
            self._paths_per_sec = (self.renderer.total_samples - samples0) / elapsed
            if controller is not None:
                spp_per_frame = controller.update(elapsed)

    def make_server(self, host: str = "0.0.0.0", port=None) -> ThreadingHTTPServer:
        """Build the HTTP server with the real request handler."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    self._route()
                except (ValueError, KeyError, IndexError) as e:
                    self.send_error(400, str(e))
                except BrokenPipeError:
                    pass

            def _route(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/":
                    body, ctype = _PAGE.encode(), "text/html"
                elif url.path == "/frame.png":
                    body, ctype = viewer._frame_png(), "image/png"
                elif url.path == "/state":
                    body, ctype = json.dumps(viewer._state()).encode(), "application/json"
                elif url.path == "/input":
                    with viewer._lock:
                        viewer._pending_keys = set(q.get("keys", [""])[0].split(",")) - {""}
                        viewer._pending_rot[0] += float(q.get("dx", [0])[0])
                        viewer._pending_rot[1] += float(q.get("dy", [0])[0])
                    body, ctype = b"ok", "text/plain"
                elif url.path == "/set":
                    with viewer._render_lock:
                        if viewer._apply_set(q):
                            viewer.renderer.reset_framebuffer()
                            viewer._scene_dirty = True
                    body, ctype = b"ok", "text/plain"
                elif url.path == "/save":
                    viewer.save(); body, ctype = b"saved", "text/plain"
                elif url.path == "/load":
                    with viewer._render_lock:
                        viewer.load()
                        viewer._scene_dirty = True
                    body, ctype = b"loaded", "text/plain"
                elif url.path == "/screenshot":
                    body, ctype = viewer.screenshot().encode(), "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return ThreadingHTTPServer((host, self.port if port is None else port), Handler)

    def start(self):
        """Serve the viewer; blocks until interrupted."""
        print(HELP_MSG)
        self._running = True
        thread = threading.Thread(target=self._render_loop, daemon=True)
        thread.start()
        server = self.make_server()
        print(f"Earth Viewer serving at http://localhost:{self.port}")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._running = False
            thread.join(timeout=5)


def render_offline(
    scene_config: SceneConfig,
    device,
    spp: int = 64,
    image_res=(1920, 1080),
    out_path: str = "render.png",
    renderer: Renderer = None,
    progress_every: int = 0,
    **renderer_kwargs,
) -> Renderer:
    """Render ``spp`` samples of ``scene_config`` on ``device`` and write the
    post-processed frame to ``out_path`` as PNG (skipped when falsy);
    ``renderer_kwargs`` (``mode``, ``cfg``, ``atlas``, ...) go to the
    Renderer. Returns the Renderer."""
    if renderer is None:
        renderer = Renderer(device, image_res=image_res, **renderer_kwargs)
    apply_config(renderer, scene_config)
    w, h = renderer.image_res
    t0 = time.time()
    for i in range(spp):
        renderer.accumulate()
        if progress_every and (i + 1) % progress_every == 0:
            renderer.color_buffer.sum().item()  # wait for the device
            rate = (i + 1) * w * h / (time.time() - t0)
            print(f"spp {i + 1}/{spp}  {rate:.3e} paths/s")
    if out_path:
        with open(out_path, "wb") as f:
            f.write(encode_png(renderer.fetch_image_np()))
    return renderer
