"""Packed per-layer arrays: the layer-axis data of the batched engine.

:func:`pack_layers` lowers a :class:`~repro.core.netinfo.NetInfo` at one
precision into a single NumPy struct — geometry, MAC counts, and
external-memory byte demands per layer — plus the index tables the
batched evaluator (:mod:`repro.core.batch_eval`) needs to slice any
split point out of it without touching a ``LayerInfo`` object again:

* the **full layer axis** (pools included) backs the generic-structure
  kernels: the generic segment for split point ``sp`` is the contiguous
  suffix ``layers[seg_start[sp]:]`` (pools trailing major layers
  ``<= sp`` are fused into their pipeline stage, exactly
  ``local_opt._segment_after``), and ``c_sufmax``/``k_sufmax`` give that
  suffix's channel maxima in O(1);
* the **major-layer axis** (plain Python ints, not arrays — the pipeline
  loops are short and sequential, where int math beats NumPy dispatch)
  backs the fast pipeline-structure evaluation: per-stage MACs, channel
  dims, kernel areas, the constant column-buffer BRAM demand, and weight
  prefix sums for the stream-bytes roofline.

Packing is cached per ``(net, dw, ww)`` — ``NetInfo`` is frozen and
hashable — so a campaign cell pays the lowering once and every PSO
particle after that reads arrays.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .netinfo import LayerInfo, NetInfo
from .pipeline_model import stage_col_ceil


@dataclasses.dataclass(frozen=True, eq=False)
class PackedLayers:
    """One network at one precision, lowered to arrays (see module doc).

    ``eq=False`` keeps identity hashing: :func:`pack_layers` caching
    guarantees one instance per ``(net, dw, ww)``, so downstream caches
    (the per-split cycle tables in ``batch_eval``) can key on it.
    """

    net: NetInfo
    dw: int
    ww: int
    # -- full layer axis, int64 arrays of shape (L,) ------------------------
    h: np.ndarray
    w: np.ndarray
    c: np.ndarray
    k: np.ndarray
    r: np.ndarray
    s: np.ndarray
    groups: np.ndarray
    is_pool: np.ndarray      # bool
    is_dw: np.ndarray        # bool: depthwise conv
    macs: np.ndarray
    ifm_bytes: np.ndarray
    ofm_bytes: np.ndarray
    weight_bytes: np.ndarray
    # -- split-point index tables -------------------------------------------
    seg_start: np.ndarray    # (n_major+1,): generic segment = layers[seg_start[sp]:]
    c_sufmax: np.ndarray     # (L+1,): max(c) over layers[i:] (0 at i == L)
    k_sufmax: np.ndarray
    # -- major-layer axis (pipeline half), plain ints -----------------------
    majors: tuple[LayerInfo, ...]
    m_macs: tuple[int, ...]
    m_c: tuple[int, ...]
    m_k: tuple[int, ...]
    m_rs: tuple[int, ...]        # kernel area R*S per stage
    m_col_ceil: tuple[int, ...]  # column-buffer BRAM blocks per stage
    m_wsum: tuple[int, ...]      # prefix weight bytes: m_wsum[i] = sum majors[:i]
    ifm0: int                    # input-frame bytes of the first major layer
    total_ops: int
    # Per-split derived tables (batch_eval's pf-ladder/cycle tensors) live
    # ON the instance so they are evicted together with it, never pinned
    # past the pack_layers cache. Mutable contents on a frozen dataclass
    # are fine: the field itself is never reassigned.
    derived: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_layers(self) -> int:
        return len(self.net.layers)

    @property
    def n_major(self) -> int:
        return len(self.majors)

    def segment(self, sp: int) -> tuple[int, int, int]:
        """Generic-segment view for split point ``sp``:
        ``(start_index, c_max, k_max)`` — the suffix ``layers[start:]``
        and its channel maxima (both 0 when the segment is empty)."""
        start = int(self.seg_start[sp])
        return start, int(self.c_sufmax[start]), int(self.k_sufmax[start])


@functools.lru_cache(maxsize=128)
def pack_layers(net: NetInfo, dw: int = 16, ww: int = 16) -> PackedLayers:
    """Lower ``net`` at precision ``(dw, ww)`` into a :class:`PackedLayers`.

    All byte/MAC columns are produced by the same ``LayerInfo`` methods
    the scalar models call, so the packed values cannot diverge from the
    reference path; this runs once per (net, precision) and is cached.
    """
    layers = net.layers
    col = lambda f: np.array([f(l) for l in layers], dtype=np.int64)
    majors = net.major_layers
    m_idx = net.major_indices
    n_l, n_m = len(layers), len(majors)

    seg_start = np.array([m_idx[sp] if sp < n_m else n_l
                          for sp in range(n_m + 1)], dtype=np.int64)
    c_arr, k_arr = col(lambda l: l.c), col(lambda l: l.k)
    c_sufmax = np.zeros(n_l + 1, dtype=np.int64)
    k_sufmax = np.zeros(n_l + 1, dtype=np.int64)
    if n_l:
        c_sufmax[:n_l] = np.maximum.accumulate(c_arr[::-1])[::-1]
        k_sufmax[:n_l] = np.maximum.accumulate(k_arr[::-1])[::-1]

    wsum = [0]
    for l in majors:
        wsum.append(wsum[-1] + l.weight_bytes(ww))

    return PackedLayers(
        net=net, dw=dw, ww=ww,
        h=col(lambda l: l.h), w=col(lambda l: l.w), c=c_arr, k=k_arr,
        r=col(lambda l: l.r), s=col(lambda l: l.s),
        groups=col(lambda l: l.groups),
        is_pool=np.array([l.kind == "pool" for l in layers]),
        is_dw=np.array([l.kind == "dwconv" for l in layers]),
        macs=col(lambda l: l.macs),
        ifm_bytes=col(lambda l: l.ifm_bytes(dw)),
        ofm_bytes=col(lambda l: l.ofm_bytes(dw)),
        weight_bytes=col(lambda l: l.weight_bytes(ww)),
        seg_start=seg_start, c_sufmax=c_sufmax, k_sufmax=k_sufmax,
        majors=majors,
        m_macs=tuple(l.macs for l in majors),
        m_c=tuple(l.c for l in majors),
        m_k=tuple(l.k for l in majors),
        m_rs=tuple(l.r * l.s for l in majors),
        m_col_ceil=tuple(stage_col_ceil(l, dw) for l in majors),
        m_wsum=tuple(wsum),
        ifm0=majors[0].ifm_bytes(dw) if majors else 0,
        total_ops=net.total_ops,
    )
