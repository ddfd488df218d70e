"""The live-lane list of the next bounce (port of
digital_earth_tpu/render/renderer.py:84 ``_compact_by_alive``): the alive
lanes binned by work class (0 cloud scatter, 1 gas scatter, 2 surface
bounce), each bin in lane order, as a stable counting sort of every lane by
``alive ? clip(work_class, 0, n_bins - 1) : n_bins``.

The reference permutes every state leaf by the list; the port keeps the
state in place and hands the list to the bounce (``pathtracer.run_bounce``),
which reads and writes each listed lane at its own slot.

``compact_by_alive_plain`` is the plain PyTorch twin, ``compact_by_alive``
the wrapper, which launches the CUDA kernel ``compact_lanes``
(csrc/compact_lanes.cu) for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import kernels

WORK_BINS = 3  # the reference's default TraceConfig.work_bins


def compact_by_alive_plain(alive, work_class, n_bins: int = WORK_BINS):
    """(idx (N,) int32, n_live (1,) int32): ``idx[:n_live]`` are the alive
    lanes in bin order, stable within each bin; the rest are the dead lanes
    in lane order (the reference's ``src``). Cumsum ranks, as the
    reference computes them."""
    n = alive.shape[0]
    dev = alive.device
    key = torch.where(alive, torch.clamp(work_class, 0, n_bins - 1), n_bins).to(torch.int64)
    one_hot = key[None, :] == torch.arange(n_bins + 1, device=dev)[:, None]
    ranks = torch.cumsum(one_hot.to(torch.int32), dim=1)  # 1-based rank in bin
    counts = one_hot.sum(dim=1, dtype=torch.int32)
    offsets = torch.cumsum(counts, dim=0) - counts
    lanes = torch.arange(n, device=dev)
    dest = offsets[key] + ranks[key, lanes] - 1
    src = torch.zeros((n,), dtype=torch.int32, device=dev)
    src[dest.to(torch.int64)] = lanes.to(torch.int32)
    return src, counts[:n_bins].sum(dtype=torch.int32).reshape(1)


def compact_by_alive(alive, work_class):
    """The binned live-lane list: the plain version for CPU tensors, the
    ``compact_lanes`` kernel for CUDA tensors (its list holds only the
    n_live alive lanes; the entries after them are unset)."""
    if alive.device.type == "cpu":
        return compact_by_alive_plain(alive, work_class)
    return kernels.compact_lanes(alive, work_class)
