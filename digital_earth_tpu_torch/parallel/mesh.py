"""Multi-device rendering (port of digital_earth_tpu/parallel/mesh.py).

One process drives an (n_px, n_spp) grid of devices, as the reference's
single-controller ``shard_map`` over its ("px", "spp") mesh does:

- the frame's tiles of the sharded block (``_pick_sharded_block``) fall into
  n_px contiguous ranges of ``tiles_per_dev`` tiles of the global tile-major
  order; device (px, s) traces range px at round ``spp0 + s`` with the
  single-device pipeline (``render/renderer.trace_lanes``: the kernels
  ``gen_rays``, the bounce entries, ``compact_lanes`` and ``frame_end``) and deposits
  each lane at its own row of row px's flat shard (tiles_per_dev * tile, 3),
  the reference's buffer layout (mesh.py:245-247);
- the "spp" partials are summed onto device (px, 0) in spp order and added
  to the shard: ``buffer + psum(rgb)`` (mesh.py:99-102);
- every lane is keyed by its global pixel id (ops/rng.py) and deposited by
  one add into its own pixel, so an (n, 1) mesh gives the single-device
  ``Renderer``'s buffer bit for bit;
- an adaptive pass scores each row's own tiles against the mean of the
  shards' means and refines its ``k_local`` best (mesh.py:156-234), with
  the ``select_tiles`` kernel's shard entries (render/adaptive.py).

Each distinct device is driven by its own worker thread: a bounce waits on
its device once, to read the live count, and frees the GIL meanwhile, so one
card's wait does not hold back the launches of another. The shards on one
device run in turn on its thread. A worker's failure stops the others at
their next bounce and fails the step; no shard is dropped. Sums between
distinct cards are copies then adds. Textures and LUTs are replicated once
per distinct device; the film runs on the first device after the shards are
assembled there.

A device may appear more than once in the grid. The shards that share it run
one after another on its thread, as that many single-device calls would.
This stands in for XLA's virtual host devices (tests/conftest.py gives the
JAX package 8 of them on one CPU): the CPU tests run meshes over
``[cpu] * n`` and one card runs them over ``[cuda:0] * n``. It adds no
capability the reference's mesh lacks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..render import adaptive
from ..render import pathtracer as pt
from ..render.params import TraceConfig
from ..render.raygen import pick_block_dims
from ..render.renderer import Renderer, trace_lanes


def _device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


class RenderMesh:
    """An (n_px, n_spp) grid of torch devices, the reference's ("px", "spp")
    ``jax.sharding.Mesh``: ``devices[px][s]``, ``shape["px"]``,
    ``shape["spp"]``."""

    def __init__(self, devices):
        self.devices = tuple(tuple(_device(d) for d in row) for row in devices)
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a render mesh is a non-empty rectangular grid of devices")
        self.shape = {"px": len(self.devices), "spp": len(self.devices[0])}

    @property
    def distinct(self):
        """Each device of the grid once, in grid order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def make_render_mesh(devices: Optional[Sequence] = None,
                     spp_axis: Optional[int] = None) -> RenderMesh:
    """The ("px", "spp") mesh over ``devices`` (mesh.py:41-55); by default
    every CUDA card, ``cuda:0`` to ``cuda:{n - 1}`` (none raises: the CPU is
    never picked unasked). ``spp_axis`` devices per px row trace their own
    spp; by default 2 when the count is even and above 1, else 1."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_render_mesh: no CUDA card; pass the devices")
        devices = [torch.device(f"cuda:{i}") for i in range(n)]
    devices = list(devices)
    n = len(devices)
    if spp_axis is None:
        spp_axis = 2 if n % 2 == 0 and n > 1 else 1
    if n == 0 or n % spp_axis:
        raise ValueError(f"{n} devices do not fill rows of {spp_axis}")
    return RenderMesh([devices[i:i + spp_axis] for i in range(0, n, spp_axis)])


def _pick_sharded_block(w: int, h: int, tile_pixels: int, n_px: int) -> Tuple[int, int]:
    """The largest block of at most ``tile_pixels`` whose tile count the px
    axis divides (mesh.py:58-65)."""
    for target in range(tile_pixels, 0, -1):
        bw, bh = pick_block_dims(w, h, target)
        if ((w // bw) * (h // bh)) % n_px == 0:
            return bw, bh
    raise ValueError((w, h, n_px))


class _Poll:
    """A step's interrupt poll, shared by its workers: True from the first
    time the caller's ``interrupt()`` says so, or once a worker failed."""

    def __init__(self, interrupt):
        self.interrupt = interrupt
        self.stop = threading.Event()
        self._lock = threading.Lock()

    def __call__(self) -> bool:
        if not self.stop.is_set() and self.interrupt is not None:
            with self._lock:
                if not self.stop.is_set() and self.interrupt():
                    self.stop.set()
        return self.stop.is_set()


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _run(jobs, poll: _Poll, sync: bool = False):
    """Run ``jobs`` [(device, fn)] on one thread per distinct device, each
    device's jobs in order, and return their results in job order. ``sync``
    waits for each device's stream at the end of its jobs. A failure stops
    the other workers at their next bounce (through ``poll``) and is raised
    once every worker has ended; failing that, ``pathtracer.Interrupted``."""
    by_dev = {}
    for i, (dev, fn) in enumerate(jobs):
        by_dev.setdefault(dev, []).append((i, fn))
    results = [None] * len(jobs)
    errors = []

    def work(dev, items):
        try:
            with _on(dev):
                for i, fn in items:
                    results[i] = fn()
                if sync and dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()  # releases the GIL
        except Exception as e:  # raised in the caller below
            errors.append(e)
            poll.stop.set()

    threads = [threading.Thread(target=work, args=item, name=f"mesh-{item[0]}")
               for item in by_dev.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failures = [e for e in errors if not isinstance(e, pt.Interrupted)]
    if failures or errors:
        raise (failures or errors)[0]
    return results


def _sum_onto(parts, dev):
    """parts[0] + parts[1] + ... on ``dev``, in that order."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


class MultiChipRenderer(Renderer):
    """The ``Renderer`` API over a render mesh (mesh.py:237-494): the
    setters, ``accumulate()`` (through a uniform adaptive pass once counts
    are live), ``accumulate_interruptible``, ``accumulate_adaptive``,
    ``fetch_image``/``fetch_image_u8``/``fetch_image_np``/``fetch_buffer``,
    ``reset_framebuffer`` and checkpoints in the reference's (W, H, 3)
    format, so the viewer drives it unchanged. Each accumulate adds
    ``spp_per_step`` samples per pixel, one per "spp" device.

    The sums live as one flat tile-major shard per px row on its device
    (rows [px * n_shard, (px + 1) * n_shard) of the frame's tile-major
    order). ``color_buffer``, ``count_buffer`` and ``lum2_buffer`` read as
    the (W, H, ...) image assembled on the first device (a copy) and, set,
    scatter an image onto the shards."""

    def __init__(self, mesh: RenderMesh, image_res=(1920, 1080), atlas=None, luts=None,
                 cfg: TraceConfig = TraceConfig(), seed: int = 0, tile_pixels: int = 2048,
                 **renderer_kwargs):
        if renderer_kwargs.get("mode", "path") != "path":
            raise ValueError("MultiChipRenderer traces path mode only")
        w, h = image_res
        self.mesh = mesh
        n_px = mesh.shape["px"]
        # the shard layout, which the buffer setters below need during
        # Renderer.__init__
        bw, bh = self.shard_block = _pick_sharded_block(w, h, tile_pixels, n_px)
        self.tiles_per_dev = (w // bw) * (h // bh) // n_px
        self.n_shard = self.tiles_per_dev * bw * bh
        super().__init__(mesh.devices[0][0], image_res=image_res, atlas=atlas, luts=luts,
                         cfg=cfg, seed=seed, tile_pixels=tile_pixels, **renderer_kwargs)
        self.block = self.shard_block
        self.tile = bw * bh
        self.spp_per_step = mesh.shape["spp"]
        self._replicas = {
            dev: (type(self.atlas)(*(t.to(dev) for t in self.atlas)),
                  type(self.luts)(*(t.to(dev) for t in self.luts)))
            for dev in mesh.distinct
        }

    # --- the shards ----------------------------------------------------------
    def _flatten(self, frame):
        """(W, H, ...) image layout -> tile-major flat (W * H, ...)."""
        (w, h), (bw, bh) = self.image_res, self.shard_block
        tail = tuple(frame.shape[2:])
        perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(tail)))
        return frame.reshape(w // bw, bw, h // bh, bh, *tail).permute(perm).reshape(w * h, *tail)

    def _assemble(self, shards):
        """The px rows' shards -> the (W, H, ...) image on the first device."""
        (w, h), (bw, bh) = self.image_res, self.shard_block
        flat = torch.cat([s.to(self.device) for s in shards])
        tail = tuple(flat.shape[1:])
        perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(tail)))
        return flat.reshape(w // bw, h // bh, bw, bh, *tail).permute(perm).reshape(w, h, *tail)

    def _scatter(self, frame):
        if frame is None:
            return None
        flat = self._flatten(frame.to(torch.float32))
        return [flat[px * self.n_shard:(px + 1) * self.n_shard].to(row[0]).contiguous()
                for px, row in enumerate(self.mesh.devices)]

    def _zeros(self, *tail):
        return [torch.zeros((self.n_shard, *tail), dtype=torch.float32, device=row[0])
                for row in self.mesh.devices]

    @property
    def color_buffer(self):
        """(W, H, 3) accumulated linear RGB, assembled on the first device."""
        return self._assemble(self._color)

    @color_buffer.setter
    def color_buffer(self, frame):
        self._color = self._scatter(frame)

    @property
    def count_buffer(self):
        """(W, H) per-pixel sample counts on the first device, or None."""
        return None if self._count is None else self._assemble(self._count)

    @count_buffer.setter
    def count_buffer(self, frame):
        self._count = self._scatter(frame)

    @property
    def lum2_buffer(self):
        return None if self._lum2 is None else self._assemble(self._lum2)

    @lum2_buffer.setter
    def lum2_buffer(self, frame):
        self._lum2 = self._scatter(frame)

    def fetch_buffer(self) -> np.ndarray:
        """(W, H, 3) accumulated linear RGB on the host."""
        return self.color_buffer.cpu().numpy()

    # --- main API ------------------------------------------------------------
    def reset_framebuffer(self):
        self.current_spp = self.total_samples = self._rng_round = self._adaptive_rounds = 0
        for shards in (self._color, self._count, self._lum2):
            for s in shards or ():
                s.zero_()

    def accumulate(self):
        """``spp_per_step`` samples per pixel (through a uniform adaptive pass
        once per-pixel counts are live)."""
        if self._count is not None:
            self.accumulate_adaptive(frac=1.0)
        else:
            self.accumulate_interruptible(1)

    def _params(self):
        """Each distinct device's (camera, scene, atlas, luts)."""
        return {dev: (self.camera_params("cpu"), self.scene_params(dev), *rep)
                for dev, rep in self._replicas.items()}

    def _trace(self, params, poll, px, s, out, lane0, n, tile_ids=None, out_index=None):
        """Device (px, s)'s job: lanes [lane0, lane0 + n) (of ``tile_ids``)
        at round ``_rng_round + s``, deposited into ``out`` at ``out_index``."""
        dev = self.mesh.devices[px][s]
        cam, scene, atlas, luts = params[dev]

        def job():
            trace_lanes(self._seed_key, self._rng_round + s, lane0, n, cam, scene, atlas, luts,
                        self.image_res, self.shard_block, self.cfg, *out, interrupt=poll,
                        tile_ids=tile_ids, out_index=out_index)

        return dev, job

    def _commit(self, shards, staged):
        """Add each px row's staged "spp" partials onto its shard."""
        for px, row in enumerate(self.mesh.devices):
            shards[px] += _sum_onto(staged[px], row[0])

    def accumulate_interruptible(self, n_chunks: int, interrupt=None) -> bool:
        """One spp per "spp" device in ~``n_chunks`` chunks of every row's
        tile range (mesh.py:311-351; the largest divisor of tiles_per_dev up
        to ``n_chunks``), polling ``interrupt()`` between chunks, once the
        devices have finished the chunk, and between bounces; an abort drops
        the partial spp and returns False. Bit-identical to ``accumulate()``.
        Raises ``ValueError`` while per-pixel counts are live."""
        if self._count is not None:
            raise ValueError(
                "interruptible accumulation does not track the adaptive per-pixel counts; "
                "use accumulate_adaptive or reset first"
            )
        tpd = self.tiles_per_dev
        n_chunks = max(d for d in range(1, min(max(int(n_chunks), 1), tpd) + 1) if tpd % d == 0)
        per = tpd // n_chunks * self.tile
        poll = _Poll(interrupt)
        params = self._params()
        n_spp = self.spp_per_step
        # an abort or a second spp device stages the step; else each lane
        # adds straight into its shard, as Renderer.accumulate does
        staged = interrupt is not None or n_spp > 1
        outs = [[torch.zeros((self.n_shard, 3), dtype=torch.float32, device=dev) for dev in row]
                if staged else [self._color[px]] for px, row in enumerate(self.mesh.devices)]
        for c in range(n_chunks):
            lo = c * per
            jobs = [self._trace(params, poll, px, s, (outs[px][s],), px * self.n_shard + lo, per,
                                out_index=torch.arange(lo, lo + per, device=row[s]))
                    for px, row in enumerate(self.mesh.devices) for s in range(n_spp)]
            try:
                _run(jobs, poll, sync=interrupt is not None)
            except pt.Interrupted:
                return False
            if interrupt is not None and c + 1 < n_chunks and poll():
                return False
        if staged:
            self._commit(self._color, outs)
        w, h = self.image_res
        self.current_spp += n_spp
        self._rng_round += n_spp
        self.total_samples += w * h * n_spp
        return True

    def accumulate_adaptive(self, frac: float = 0.25, min_warmup: int = 2,
                            interrupt=None) -> bool:
        """One sharded adaptive pass (mesh.py:156-234, 353-395): each px row
        scores its own tiles against ``m_bar``, the mean of the rows' shard
        means, and every device of the row traces one more sample for each
        pixel of the row's ``k_local = max(1, min(tiles_per_dev,
        int(tiles_per_dev * frac)))`` best tiles; the first ``min_warmup``
        passes, and any with ``frac >= 1``, take every tile. ``lum2`` adds
        each spp's squared luminance, ``count`` the spp devices. Selection per
        row, not over the frame, as the reference has it: no gather, and
        every device refines its own noisiest tiles. ``interrupt()`` is
        polled between bounces; an abort leaves every buffer and counter as
        it was and returns False."""
        if self._count is None:
            if self.current_spp:
                raise ValueError(
                    "adaptive accumulation must start from a reset framebuffer (per-pixel "
                    "counts for the earlier uniform passes were not tracked)"
                )
            self._count, self._lum2 = self._zeros(), self._zeros()
        tpd, tile, n_spp = self.tiles_per_dev, self.tile, self.spp_per_step
        n_px = self.mesh.shape["px"]
        uniform = self._adaptive_rounds < min_warmup or frac >= 1.0
        k_local = tpd if uniform else max(1, min(tpd, int(tpd * frac)))
        poll = _Poll(interrupt)
        params = self._params()
        rows = self.mesh.devices
        if not uniform:
            means = _run([(row[0], lambda px=px: adaptive.shard_mean(self._color[px],
                                                                     self._count[px]))
                          for px, row in enumerate(rows)], poll)
            m_bar = _sum_onto(means, self.device) / n_px  # pmean over "px", on the device
            local_ids = _run([(row[0], lambda px=px: adaptive.select_tiles_shard(
                self._color[px], self._count[px], self._lum2[px], tile, k_local,
                m_bar.to(rows[px][0]))) for px, row in enumerate(rows)], poll)
        staged = interrupt is not None or n_spp > 1
        outs = [[tuple(torch.zeros((self.n_shard, *t), dtype=torch.float32, device=dev)
                       for t in ((3,), (), ())) for dev in row]
                if staged else [(self._color[px], self._count[px], self._lum2[px])]
                for px, row in enumerate(rows)]
        jobs = []
        for px, row in enumerate(rows):
            for s, dev in enumerate(row):
                if uniform:
                    jobs.append(self._trace(params, poll, px, s, outs[px][s], px * self.n_shard,
                                            self.n_shard,
                                            out_index=torch.arange(self.n_shard, device=dev)))
                    continue
                local = local_ids[px].to(dev)
                lanes = (local.to(torch.int64)[:, None] * tile
                         + torch.arange(tile, device=dev)).reshape(-1)
                jobs.append(self._trace(params, poll, px, s, outs[px][s], 0, k_local * tile,
                                        tile_ids=local + px * tpd, out_index=lanes))
        try:
            _run(jobs, poll)
        except pt.Interrupted:
            return False
        if staged:
            for i, shards in enumerate((self._color, self._count, self._lum2)):
                self._commit(shards, [[parts[i] for parts in row] for row in outs])
        self._rng_round += n_spp
        self._adaptive_rounds += 1
        self.total_samples += k_local * n_px * tile * n_spp
        if uniform:
            self.current_spp += n_spp
        return True
