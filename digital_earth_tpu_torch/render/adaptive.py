"""Tile selection for adaptive sampling (port of
digital_earth_tpu/render/renderer.py:425 ``_select_tiles``): the plain
PyTorch version ``select_tiles_plain`` and the wrapper ``select_tiles``,
which launches the CUDA kernel ``select_tiles`` (csrc/select_tiles.cu) for
a CUDA render device. Per device of a render mesh
(digital_earth_tpu/parallel/mesh.py:189-204) the same statistic runs in two
halves: ``shard_mean`` (each shard's mean) and ``select_tiles_shard`` (its
own tiles, against the mean of the shards' means), twins
``shard_mean_plain`` and ``select_tiles_shard_plain``.

Per pixel, with ``n = max(count, 1)``, the variance of its mean luminance,
``var_mean = max(lum2 / n - mean_lum^2, 0) / n``, is scored against a
mid-grey anchor and an exploration floor set by the frame mean ``m_bar``;
a never-sampled pixel scores +inf; a tile scores the mean of its pixels,
and the ``k`` best tiles come back in ``lax.top_k``'s order: descending in
XLA's total order of float32 (-NaN < -inf < ... < -0 < +0 < ... < +inf <
+NaN), ties to the lower tile id. So a NaN score, from an infinite or NaN
buffer value, still leaves ``k`` distinct tiles.

Sums are fixed halving trees (``tree_sum``) over zero-padded power-of-two
rows: the frame mean over chunks of 1024 pixels in pixel-id order, then
over the chunks; a tile's score over its pixels in in-tile lane order. The
kernel sums in the same order, so kernel and plain version pick the same
tiles; the reference sums in XLA's order, so a score can differ from it by
an ulp.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..ops import spectral as sp

CHUNK = 1024  # pixels per partial sum of the frame mean (csrc/select_tiles.cu)


def tree_sum(x):
    """Sum over the last axis by halving a zero-padded power-of-two row:
    x[..., i] + x[..., i + h] for h = p/2, ..., 1."""
    m = x.shape[-1]
    p = 1 << max(0, (m - 1).bit_length())
    x = F.pad(x, (0, p - m))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _scalar(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _mean_lum(color, count):
    return sp.lum(color) / torch.clamp(count, min=1.0)


def _mean(mean_lum):
    """The mean of a flat row by chunk trees, then a tree over the chunks."""
    pad = -mean_lum.shape[0] % CHUNK
    partial = tree_sum(F.pad(mean_lum, (0, pad)).view(-1, CHUNK))
    return tree_sum(partial) / _scalar(float(mean_lum.shape[0]), mean_lum)


def _pixel_scores(color, count, lum2, m_bar):
    n = torch.clamp(count, min=1.0)
    mean_lum = sp.lum(color) / n
    var_mean = torch.clamp(lum2 / n - mean_lum * mean_lum, min=0.0) / n
    anchor = 0.2 * m_bar + 1e-20
    explore = (0.2 * m_bar) * (0.2 * m_bar) / (n * n)
    d = mean_lum + anchor
    score = (var_mean + explore) / (d * d)
    return torch.where(count < 1.0, torch.inf, score)


def tile_scores_plain(color, count, lum2, block):
    """(n_tiles,) scores in tile order bx * nby + by (renderer.py:442-464)."""
    w, h = count.shape
    bw, bh = block
    nbx, nby = w // bw, h // bh
    m_bar = _mean(_mean_lum(color, count).reshape(-1))
    score = _pixel_scores(color, count, lum2, m_bar)
    per_tile = score.reshape(nbx, bw, nby, bh).permute(0, 2, 1, 3).reshape(nbx * nby, bw * bh)
    return tree_sum(per_tile) / _scalar(float(bw * bh), score)


def order_keys(x):
    """float32 -> int32 keys in XLA's total order (lax.top_k's)."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def select_tiles_plain(color, count, lum2, block, k: int):
    """Plain PyTorch twin of the ``select_tiles`` kernel: the (k,) int32
    ids of the highest-scoring tiles, descending in XLA's total order, ties
    to the lower id."""
    scores = tile_scores_plain(color, count, lum2, block)
    order = torch.sort(order_keys(scores), descending=True, stable=True).indices
    return order[:k].to(torch.int32)


def _kernel_params():
    return [*sp.LUM_WEIGHTS.tolist(), float(np.float32(0.2)), float(np.float32(1e-20))]


def select_tiles(color, count, lum2, block, k: int):
    """The ``k`` tiles of ``block`` to sample next: the plain version for CPU
    buffers, the ``select_tiles`` kernel for CUDA ones."""
    if color.device.type == "cpu":
        return select_tiles_plain(color, count, lum2, block, k)
    return kernels.select_tiles(_kernel_params(), color, count, lum2, block, k)


# --- one device's shard of a render mesh (parallel/mesh.py:189-204) ----------
# The buffers are the device's flat tile-major shard: color (P, 3), count and
# lum2 (P,), tile t at pixels [t * tile, (t + 1) * tile) in in-tile lane order.


def shard_mean_plain(color, count):
    """Plain twin of ``kernels.shard_mean``: the (1,) mean of
    lum(color) / max(count, 1) over the shard, in the frame mean's sum order
    (chunks of 1024 pixels in lane order, then the chunks)."""
    return _mean(_mean_lum(color, count)).reshape(1)


def shard_scores_plain(color, count, lum2, tile: int, m_bar):
    """The shard's (n_tiles,) tile scores against the frame mean ``m_bar``
    (1,), in tile order."""
    score = _pixel_scores(color, count, lum2, m_bar).view(-1, tile)
    return tree_sum(score) / _scalar(float(tile), score)


def select_tiles_shard_plain(color, count, lum2, tile: int, k: int, m_bar):
    """Plain twin of ``kernels.select_tiles_shard``: the (k,) int32
    shard-local ids of the shard's highest-scoring tiles against the frame
    mean ``m_bar`` (1,), descending in XLA's total order, ties to the lower
    id."""
    scores = shard_scores_plain(color, count, lum2, tile, m_bar)
    order = torch.sort(order_keys(scores), descending=True, stable=True).indices
    return order[:k].to(torch.int32)


def shard_mean(color, count):
    """A shard's mean luminance: the plain version for CPU buffers, stages
    1-2 of the ``select_tiles`` kernel (de_shard_mean) for CUDA ones."""
    if color.device.type == "cpu":
        return shard_mean_plain(color, count)
    return kernels.shard_mean(_kernel_params(), color, count)


def select_tiles_shard(color, count, lum2, tile: int, k: int, m_bar):
    """A shard's ``k`` tiles to sample next against the frame mean ``m_bar``:
    the plain version for CPU buffers, stages 3-4 of the ``select_tiles``
    kernel (de_select_tiles_shard) for CUDA ones."""
    if color.device.type == "cpu":
        return select_tiles_shard_plain(color, count, lum2, tile, k, m_bar)
    return kernels.select_tiles_shard(_kernel_params(), color, count, lum2, tile, k, m_bar)
