"""Cross-cell DSE screen: the hyperband rung-0 relaxation for many campaign
cells in one call on the card.

The counterpart of ``repro/core/screen_jax.py``. ``cell_tables`` and
``stack_cells`` are NumPy, as there: the tables are the port's own
``batch_eval._screen_tables`` of ``pack_layers(net, dw, ww)``, the ones
``batch_eval.screen_rav_batch`` reads. ``screen_cells``
is ``screen_jax._screen_one`` broadcast over (cells, n) in float64/int64:
the per-cell tables are gathered with ``torch.gather``, and the rounding
(``torch.round``, half to even), the truncating ``.to(torch.int64)`` and
the floor divisions are NumPy's. Its output is bit-equal to
``batch_eval.screen_rav_batch`` run cell by cell
(``tests/test_torch_screen.py``); each elementwise float64 operation is a
kernel of its own, so no product is fused into an addition on the card.

    tables = [cell_tables(net, fpga, dw, ww) for ... each cell]
    stacked = stack_cells(tables)
    ips = screen_cells(stacked, positions)   # (cells, n, 5) -> (cells, n)

``stacked`` may come from either package's ``stack_cells``: both are the
same dict of NumPy arrays.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve
from .batch_eval import _screen_tables
from .hw_specs import FPGASpec, alpha_for
from .layer_arrays import pack_layers
from .netinfo import NetInfo


def cell_tables(net: NetInfo, fpga: FPGASpec, dw: int = 16, ww: int = 16) -> dict:
    """One cell's screening inputs: the NumPy reference's cached
    prefix/suffix tables (:func:`repro_torch.core.batch_eval._screen_tables`,
    shared, not recomputed) plus the hardware scalars the screen closes
    over, as ``screen_jax.cell_tables``."""
    packed = pack_layers(net, dw, ww)
    t = _screen_tables(packed)
    return {
        "pipe_macs": t["pipe_macs"], "pipe_w": t["pipe_w"],
        "seg_start": t["seg_start"],
        "tail_macs": t["tail_macs"], "tail_w": t["tail_w"],
        "n_major": packed.n_major, "n_layers": packed.n_layers,
        "ifm0": float(packed.ifm0),
        "alpha": alpha_for(min(dw, ww)),
        "freq": float(fpga.freq),
        "bw_total": float(fpga.bw_gbps * 1e9),
        "dsp_usable": int(fpga.dsp_usable),
    }


def stack_cells(tables: Sequence[dict]) -> dict:
    """Pad per-cell tables to common lengths and stack to (cells, ...)
    arrays. Zero padding is sound: a cell's gathers are clipped to its own
    ``n_major`` / terminal ``seg_start``, so padded entries are never
    addressed."""
    lp = max(len(t["pipe_macs"]) for t in tables)
    lt = max(len(t["tail_macs"]) for t in tables)

    def padf(key: str, width: int) -> np.ndarray:
        out = np.zeros((len(tables), width), dtype=np.float64)
        for i, t in enumerate(tables):
            a = np.asarray(t[key], dtype=np.float64)
            out[i, :len(a)] = a
        return out

    seg = np.zeros((len(tables), lp), dtype=np.int64)
    for i, t in enumerate(tables):
        a = np.asarray(t["seg_start"], dtype=np.int64)
        seg[i, :len(a)] = a
        if len(a) < lp:
            seg[i, len(a):] = a[-1] if len(a) else 0
    return {
        "pipe_macs": padf("pipe_macs", lp), "pipe_w": padf("pipe_w", lp),
        "seg_start": seg,
        "tail_macs": padf("tail_macs", lt), "tail_w": padf("tail_w", lt),
        **{k: np.asarray([t[k] for t in tables], dtype=np.int64)
           for k in ("n_major", "n_layers", "alpha", "dsp_usable")},
        **{k: np.asarray([t[k] for t in tables], dtype=np.float64)
           for k in ("ifm0", "freq", "bw_total")},
    }


def _screen(tab: dict, arr: torch.Tensor) -> torch.Tensor:
    """Every cell's screen at once: ``screen_jax._screen_one`` with each
    per-cell scalar a (cells, 1) column and each table lookup a gather
    along the cell's row; the same dtypes, rounding and where-guards."""
    col = {k: tab[k][:, None] for k in ("n_major", "n_layers", "alpha", "dsp_usable",
                                        "ifm0", "freq", "bw_total")}
    zero, inf = arr.new_zeros(()), arr.new_full((), float("inf"))
    sp = torch.minimum(torch.round(arr[..., 0]).to(torch.int64).clamp(min=0), col["n_major"])
    batch = torch.clamp(torch.round(arr[..., 1]), min=1.0)
    has_pipe = sp > 0
    dsp_p = torch.where(has_pipe, (col["dsp_usable"] * arr[..., 2]).to(torch.int64),
                        torch.zeros_like(sp))
    bw_p = torch.where(has_pipe, col["bw_total"] * arr[..., 4], zero)

    pf_p = torch.clamp(torch.div(dsp_p * col["alpha"], 2, rounding_mode="floor"),
                       min=1).to(torch.float64)
    comp_p = batch * torch.gather(tab["pipe_macs"], 1, sp) / (pf_p * col["freq"])
    stream = torch.gather(tab["pipe_w"], 1, sp) + batch * col["ifm0"]
    mem_p = torch.where(bw_p > 0, stream / bw_p, torch.where(stream > 0, inf, zero))
    lat_p = torch.where(has_pipe, torch.maximum(comp_p, mem_p), zero)

    start = torch.gather(tab["seg_start"], 1, sp)
    tm, tw = torch.gather(tab["tail_macs"], 1, start), torch.gather(tab["tail_w"], 1, start)
    has_tail = start < col["n_layers"]
    pf_g = torch.clamp(torch.div(torch.clamp(col["dsp_usable"] - dsp_p, min=0) * col["alpha"],
                                 2, rounding_mode="floor"), min=1).to(torch.float64)
    comp_g = batch * tm / (pf_g * col["freq"])
    bw_g = col["bw_total"] - bw_p
    mem_g = torch.where(bw_g > 0, tw / bw_g, torch.where(tw > 0, inf, zero))
    lat_g = torch.where(has_tail, torch.maximum(comp_g, mem_g), zero)

    lat = torch.maximum(lat_p, lat_g)
    return torch.where((lat > 0) & torch.isfinite(lat), batch / lat, zero)


def screen_cells(stacked: dict, positions, *, device="cuda") -> np.ndarray:
    """Screen (cells x candidates) in one call on ``device``.

    ``stacked`` is ``stack_cells`` output; ``positions`` is the (cells, n, 5)
    rung-0 position block, one row of raw search-space positions per
    candidate. Returns (cells, n) relaxed img/s, bit-identical to running
    the NumPy ``screen_rav_batch`` per cell.
    """
    device = resolve(device)
    pos = np.asarray(positions, dtype=np.float64)
    if pos.ndim != 3 or pos.shape[2] != 5:
        raise ValueError(f"positions must be (cells, n, 5); got {pos.shape}")
    if pos.shape[0] != len(stacked["n_major"]):
        raise ValueError(f"positions batch {pos.shape[0]} != {len(stacked['n_major'])} "
                         f"stacked cells")
    tab = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in stacked.items()}
    return _screen(tab, torch.from_numpy(pos).to(device)).cpu().numpy()
