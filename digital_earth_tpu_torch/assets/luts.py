"""Spectral and camera-response LUTs as torch tensors (port of
digital_earth_tpu/assets/luts.py). Reads the JAX package's committed .npz
assets; the table source rule (``DE_LUT_SOURCE``, reference tables when
present) is the same."""

from __future__ import annotations

import os
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..ops.spectral import cie_g

# The JAX package's committed tables, read as files (nothing is imported).
DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "digital_earth_tpu", "assets", "data",
)


class SpectralLUTs(NamedTuple):
    """cie_cdf (441, 3), cie_response (441, 3), srgb2spec (300, 3),
    o3_crossec (441,) — all float32."""

    cie_cdf: torch.Tensor
    cie_response: torch.Tensor
    srgb2spec: torch.Tensor
    o3_crossec: torch.Tensor


class CRFPack(NamedTuple):
    """Camera response curves (1024, n_films, 3) + film names."""

    curves: torch.Tensor
    names: tuple


def _t(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def load_spectral_luts(device, data_dir: str = DATA_DIR, source: str = None) -> SpectralLUTs:
    if source is None:
        source = os.environ.get("DE_LUT_SOURCE")
    if source is None:
        source = (
            "reference"
            if os.path.exists(os.path.join(data_dir, "cie_lut_ref.npz"))
            else "generated"
        )
    suffix = "_ref" if source == "reference" else ""
    cie = np.load(os.path.join(data_dir, f"cie_lut{suffix}.npz"))
    s2s = np.load(os.path.join(data_dir, f"srgb2spec{suffix}.npz"))
    o3 = np.load(os.path.join(data_dir, f"ozone_lut{suffix}.npz"))
    luts = SpectralLUTs(
        cie_cdf=_t(cie["cdf"], device),
        cie_response=_t(cie["response"], device),
        srgb2spec=_t(s2s["basis"], device),
        o3_crossec=_t(o3["cross_section"], device),
    )
    _record_ray_tables(luts.cie_cdf, np.asarray(cie["cdf"], np.float32)[-1].tolist())
    return luts


# The ray generator's view of a set's CIE tables, by cie_cdf tensor: the
# inversion's scalar CDF g (ops/spectral.cie_g) on the tables' device, and
# the CDF's last row (each channel's total) as Python floats.
# load_spectral_luts records both from the arrays it uploads; for tables
# made otherwise they are derived once, at first use.
_RAY_TABLES = {}


def _record_ray_tables(cdf, totals):
    key = id(cdf)

    def forget(ref):
        if _RAY_TABLES.get(key, (None,))[0] is ref:
            del _RAY_TABLES[key]

    entry = (weakref.ref(cdf, forget), cie_g(cdf), tuple(float(x) for x in totals))
    _RAY_TABLES[key] = entry
    return entry


def ray_tables(luts: SpectralLUTs):
    """(g, cdf totals) of ``luts``: g the (res,) float32 tensor the CIE
    inversion searches, the totals the CDF's last row as three floats."""
    cdf = luts.cie_cdf
    entry = _RAY_TABLES.get(id(cdf))
    if entry is None or entry[0]() is not cdf:
        entry = _record_ray_tables(cdf, cdf[cdf.shape[0] - 1].tolist())
    return entry[1], entry[2]


def load_crf_pack(device, data_dir: str = DATA_DIR) -> CRFPack:
    pack = np.load(os.path.join(data_dir, "crf_pack.npz"))
    return CRFPack(
        curves=_t(pack["curves"], device),
        names=tuple(str(n) for n in pack["names"]),
    )
