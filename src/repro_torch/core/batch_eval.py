"""Batched analytical-model engine: ``evaluate_rav`` as array kernels.

The paper's DSE throughput lives or dies on how fast the analytical
models evaluate ("fast exploration of various accelerator designs",
Sec. 7). The scalar reference path re-walks every layer in Python for
each of Algorithm 3's pf-doublings and rollbacks; this module evaluates
the same math over packed NumPy layer arrays
(:mod:`repro.core.layer_arrays`):

* the **generic structure**'s Algorithm-3 doubling sweep is one
  broadcasted ``(pf_levels, strategies, layers)`` latency tensor per
  rollback — every pf level and both buffer strategies at once — with the
  per-level MAC-array cycle table cached per ``(net, precision, split)``;
* the **pipeline structure**'s Algorithm-2 allocation (CTC allocate,
  halve-to-fit, bottleneck refinement) runs over plain int/float lists
  with zero ``StageDesign`` churn, calling the *same* formula helpers
  (``stage_dsp``/``stage_bram``/``split_pf``) as the dataclass path;
* :func:`evaluate_rav_batch` evaluates a whole PSO population: all
  candidates at one split point share the packed segment and cycle
  tables, with rollbacks diverging per candidate.

``local_opt.evaluate_rav`` stays the reference implementation. This
engine reproduces it decision-for-decision: every discrete output (RAV,
stage PF splits, strategy choice, DSP/BRAM usage, feasibility) is
identical, and float objectives agree to ~1e-9 relative (the only
difference is NumPy's pairwise summation over the layer axis vs Python's
sequential ``sum``) — enforced by the randomized equivalence sweep in
``tests/test_batch_eval.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np

from .generic_model import (ABUFF_FRAC, BRAM_BITS, FMBUFF_FRAC, WBUFF_FRAC,
                            GenericDesign)
from .hw_specs import FPGASpec, alpha_for
from .layer_arrays import PackedLayers, pack_layers
from .local_opt import RAV, DesignPoint
from .netinfo import NetInfo
from .pipeline_model import (PipelineDesign, StageDesign, _pow2_floor,
                             split_pf, stage_bram, stage_dsp)


def _cdiv(a: np.ndarray, b) -> np.ndarray:
    """Exact integer ceil-division (== ``math.ceil(a / b)`` for our ranges)."""
    return -(-a // b)


# Pure int->int formulas whose arguments repeat massively across a
# population (pf ladders over the same layer dims): memoized views of the
# SAME pipeline_model functions, so results stay bit-identical.
_split_pf = functools.lru_cache(maxsize=1 << 16)(split_pf)
_stage_bram = functools.lru_cache(maxsize=1 << 16)(stage_bram)

# Hit/miss tallies for the one cache lru_cache can't see (the per-split
# level tables living on each PackedLayers instance). Plain int adds —
# no measurable cost next to the array math they sit beside.
_LEVELS_STATS = {"hits": 0, "misses": 0}


def cache_stats() -> dict[str, dict[str, int]]:
    """Hit/miss counters for every cache the batched engine leans on,
    as ``{cache: {hits, misses}}`` — the campaign tracer gauges these
    per cell so reports can show how much table reuse a search got.
    Counters are process-global and monotonic; diff two snapshots to
    attribute activity to one cell."""
    return {
        "pack_layers": _info(pack_layers.cache_info()),
        "split_pf": _info(_split_pf.cache_info()),
        "stage_bram": _info(_stage_bram.cache_info()),
        "levels": dict(_LEVELS_STATS),
    }


def _info(ci) -> dict[str, int]:
    return {"hits": ci.hits, "misses": ci.misses}


# ---------------------------------------------------------------------------
# Generic structure: per-split level tables + the Algorithm-3 sweep kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _Levels:
    """Everything about one generic segment that does NOT depend on the
    RAV: the pf-doubling ladder (up to MAC-array saturation) and the
    per-layer demand columns the latency kernel broadcasts against."""

    # pf ladder, int64 (P,)
    pf: np.ndarray
    cpf: np.ndarray
    kpf: np.ndarray
    ck: np.ndarray        # cpf * kpf (saturation check: ck < pf)
    dsp: np.ndarray       # GenericDesign.dsp() per level
    cycles_f: np.ndarray  # (P, L) MAC-array passes per frame, float64
    # segment layer columns (L,)
    w_f: np.ndarray       # weight bytes, float64
    fm_base: np.ndarray   # h*w*k*dw (accumulation-buffer demand), int64
    fit_base: np.ndarray  # (ifm+ofm)*8 bits (fm-buffer fit check), int64
    io_b: np.ndarray      # ifm+ofm bytes (spill traffic), int64
    ifm_f: np.ndarray
    ofm_f: np.ndarray
    needw_f: np.ndarray   # weight-buffer demand bits (0 for pools), float64


def _gen_levels(packed: PackedLayers, sp: int) -> _Levels | None:
    """Level table for ``packed``'s generic segment at split ``sp`` (None
    when the segment is empty), cached on the instance's ``derived`` dict
    so the tables live and die with the packed layers themselves."""
    try:
        lv = packed.derived[sp]
        _LEVELS_STATS["hits"] += 1
        return lv
    except KeyError:
        pass
    _LEVELS_STATS["misses"] += 1
    lv = packed.derived[sp] = _build_levels(packed, sp)
    return lv


def _build_levels(packed: PackedLayers, sp: int) -> _Levels | None:
    start, c_max, k_max = packed.segment(sp)
    if start >= packed.n_layers:
        return None
    sl = slice(start, packed.n_layers)
    h, w, c, k = packed.h[sl], packed.w[sl], packed.c[sl], packed.k[sl]
    r, s, groups = packed.r[sl], packed.s[sl], packed.groups[sl]
    is_pool, is_dw = packed.is_pool[sl], packed.is_dw[sl]
    alpha = alpha_for(min(packed.dw, packed.ww))

    # pf ladder: 1, 2, 4, ... until split_pf saturates (cpf*kpf < pf) —
    # Algorithm 3's inner loop can never visit a level past that.
    pf, ladder = 1, []
    while True:
        cpf, kpf = split_pf(pf, c_max, k_max)
        ladder.append((pf, cpf, kpf))
        if cpf * kpf < pf:
            break
        pf *= 2
    pfs = np.array([x[0] for x in ladder], dtype=np.int64)
    cpfs = np.array([x[1] for x in ladder], dtype=np.int64)
    kpfs = np.array([x[2] for x in ladder], dtype=np.int64)

    pix = h * w                      # ceil(h*w / pixel_par) at pixel_par=1
    base = pix * r * s
    cin = c // groups
    rows = []
    for _, cpf, kpf in ladder:
        # Eq. 6 per level: dwconv uses only the CPF lanes; pools are free.
        cyc = np.where(is_dw, base * _cdiv(c, cpf),
                       base * _cdiv(cin, cpf) * _cdiv(k, kpf))
        rows.append(np.where(is_pool, 0, cyc))
    ifm, ofm = packed.ifm_bytes[sl], packed.ofm_bytes[sl]
    return _Levels(
        pf=pfs, cpf=cpfs, kpf=kpfs, ck=cpfs * kpfs,
        dsp=np.maximum(1, (2 * cpfs * kpfs) // alpha),
        cycles_f=np.stack(rows).astype(np.float64),
        w_f=packed.weight_bytes[sl].astype(np.float64),
        fm_base=h * w * k * packed.dw,
        fit_base=(ifm + ofm) * 8,
        io_b=ifm + ofm,
        ifm_f=ifm.astype(np.float64), ofm_f=ofm.astype(np.float64),
        needw_f=np.where(is_pool, 0,
                         r * s * cin * k * packed.ww).astype(np.float64),
    )


def _alg3_sweep(lv: _Levels, batch: int, freq: float, bram_avail: int,
                bw_g: float, dsp_avail: int, target: float | None,
                pf_cap: int) -> tuple[int, int, float] | None:
    """One Algorithm-3 doubling sweep: the whole (pf level x strategy x
    layer) latency tensor in one broadcast, then the reference loop's
    stopping scan over it. Returns ``(level, strategy_index, latency)``
    for the level the scalar loop would settle on, or None when even
    PF=1 exceeds ``dsp_avail`` (the caller rolls the pipeline back)."""
    # Buffer capacities — the exact GenericDesign property expressions.
    bits = bram_avail * BRAM_BITS
    half_ab = np.array([max(1, int(bits * ABUFF_FRAC[s]) // 2)
                        for s in (1, 2)], dtype=np.float64)
    half_fm = np.array([int(bits * FMBUFF_FRAC[s]) // 2
                        for s in (1, 2)], dtype=np.int64)
    half_w2 = max(1, int(bits * WBUFF_FRAC[2]) // 2)

    # Traffic amplification (Eqs. 5/8/11-13) for both strategies at once.
    need_fm = (batch * lv.fm_base).astype(np.float64)
    g_fm = np.maximum(1.0, np.ceil(need_fm[None, :] / half_ab[:, None]))
    fits = (batch * lv.fit_base) <= half_fm[:, None]
    spill = (batch * lv.io_b).astype(np.float64)
    t_is = lv.w_f[None, :] * g_fm + np.where(fits, 0.0, spill[None, :])
    g_w2 = np.maximum(1.0, np.ceil(lv.needw_f / half_w2))
    t_ws = lv.w_f + batch * (lv.ifm_f * g_w2 + lv.ofm_f)
    traffic = np.stack([t_is[0], np.minimum(t_is[1], t_ws)])
    if bw_g > 0:
        mem = traffic / bw_g
    else:  # zero-traffic layers (on-chip pools) stay free even with no BW
        mem = np.where(traffic > 0, np.inf, 0.0)

    comp = batch * (lv.cycles_f / freq)                        # (P, L)
    lat = np.maximum(comp[:, None, :], mem[None, :, :]).sum(axis=2)

    # The reference inner loop's scan: advance while the generic half is
    # slower than the pipeline half and parallelism can still double.
    level, st, chosen = -1, 0, math.inf
    for i in range(len(lv.pf)):
        if lv.dsp[i] > dsp_avail:
            break
        level = i
        st = 0 if lat[i, 0] <= lat[i, 1] else 1   # ties: strategy 1
        chosen = float(lat[i, st])
        if target is not None and chosen <= target:
            break
        if lv.pf[i] >= pf_cap or lv.ck[i] < lv.pf[i]:
            break
    if level < 0:
        return None
    return level, st, chosen


# ---------------------------------------------------------------------------
# Pipeline structure: Algorithm 2 over plain lists (no dataclass churn)
# ---------------------------------------------------------------------------


class _PipeState:
    """``design_pipeline`` + ``scale_down`` + the latency roofline over
    int/float lists. Uses the same ``stage_dsp``/``stage_bram``/
    ``split_pf`` helpers as :class:`~repro.core.pipeline_model.StageDesign`,
    so every resource count and latency is bit-identical to the
    reference path."""

    __slots__ = ("packed", "n", "alpha", "freq", "batch",
                 "cpf", "kpf", "dsp_l", "bram_l", "comp",
                 "dsp_sum", "bram_sum")

    def __init__(self, packed: PackedLayers, sp: int, dsp_cap: int,
                 bram_cap: int, bw: float, freq: float, batch: int,
                 alpha: int):
        self.packed, self.n = packed, sp
        self.alpha, self.freq, self.batch = alpha, freq, batch
        m, c, k = packed.m_macs, packed.m_c, packed.m_k
        total_w = packed.m_wsum[sp]
        if total_w == 0 or bw <= 0:       # ctc_allocate's degenerate case
            pfs = [1] * sp
        else:                             # Algorithm 2 lines 4-6
            pfs = [max(1, _pow2_floor(m[i] * bw / total_w / freq))
                   for i in range(sp)]
        self.cpf, self.kpf = [], []
        for i in range(sp):
            a, b = _split_pf(pfs[i], c[i], k[i])
            self.cpf.append(a)
            self.kpf.append(b)
        self._refresh()
        # Algorithm 2 line 9: halve until resources fit.
        while sp and (self.dsp_sum > dsp_cap or self.bram_sum > bram_cap):
            if self.all_pf1():
                break
            self.scale_down()
        # Refinement: greedily double the slowest stage while it fits.
        while sp:
            i = max(range(sp), key=lambda j: self.comp[j])
            pf = self.cpf[i] * self.kpf[i]
            if pf >= c[i] * k[i]:
                break
            ncpf, nkpf = _split_pf(pf * 2, c[i], k[i])
            npf = ncpf * nkpf
            if npf <= pf:
                break
            nd = stage_dsp(npf, alpha)
            nb = _stage_bram(ncpf, nkpf, packed.dw, packed.ww,
                             packed.m_col_ceil[i], packed.m_rs[i])
            if (self.dsp_sum - self.dsp_l[i] + nd > dsp_cap
                    or self.bram_sum - self.bram_l[i] + nb > bram_cap):
                break
            self.cpf[i], self.kpf[i] = ncpf, nkpf
            self.dsp_sum += nd - self.dsp_l[i]
            self.bram_sum += nb - self.bram_l[i]
            self.dsp_l[i], self.bram_l[i] = nd, nb
            self.comp[i] = m[i] / (npf * freq)

    def _refresh(self) -> None:
        p = self.packed
        self.dsp_l, self.bram_l, self.comp = [], [], []
        for i in range(self.n):
            pf = self.cpf[i] * self.kpf[i]
            self.dsp_l.append(stage_dsp(pf, self.alpha))
            self.bram_l.append(_stage_bram(self.cpf[i], self.kpf[i], p.dw,
                                           p.ww, p.m_col_ceil[i], p.m_rs[i]))
            self.comp.append(p.m_macs[i] / (pf * self.freq))
        self.dsp_sum = sum(self.dsp_l)
        self.bram_sum = sum(self.bram_l)

    def all_pf1(self) -> bool:
        return all(self.cpf[i] * self.kpf[i] == 1 for i in range(self.n))

    def scale_down(self) -> None:
        """Algorithm 2 line 9 / Algorithm 3 line 13: PF_i = max(1, PF_i/2)."""
        c, k = self.packed.m_c, self.packed.m_k
        for i in range(self.n):
            a, b = _split_pf(max(1, (self.cpf[i] * self.kpf[i]) // 2),
                             c[i], k[i])
            self.cpf[i], self.kpf[i] = a, b
        self._refresh()

    def batch_latency(self, bw: float) -> float:
        if not self.n:
            return 0.0
        l_comp = self.batch * max(self.comp)
        stream = self.packed.m_wsum[self.n] + self.batch * self.packed.ifm0
        l_mem = stream / bw if bw > 0 else float("inf")
        return max(l_comp, l_mem)

    def throughput(self, bw: float) -> float:
        if not self.n:
            return float("inf")
        lat = self.batch_latency(bw)
        return self.batch / lat if lat > 0 else 0.0


# ---------------------------------------------------------------------------
# Whole-RAV evaluation + the population-batch entry point
# ---------------------------------------------------------------------------


def _eval_rav_fast(packed: PackedLayers, fpga: FPGASpec, rav: RAV,
                   max_rollbacks: int) -> DesignPoint:
    """Algorithms 2+3 for one RAV over packed arrays; mirrors
    ``local_opt.evaluate_rav`` decision-for-decision."""
    freq = fpga.freq
    sp = max(0, min(rav.sp, packed.n_major))
    batch = rav.batch
    dsp_p = int(fpga.dsp_usable * rav.dsp_frac) if sp else 0
    bram_p = int(fpga.bram_usable * rav.bram_frac) if sp else 0
    bw_p = fpga.bw_gbps * 1e9 * rav.bw_frac if sp else 0.0
    bw_g = fpga.bw_gbps * 1e9 - bw_p
    alpha = alpha_for(min(packed.dw, packed.ww))

    pipe = _PipeState(packed, sp, dsp_p, bram_p, bw_p, freq, batch, alpha)

    # ---- Algorithm 3: grow the generic structure until balanced ----------
    lv = _gen_levels(packed, sp)
    sel: tuple[int, int, float] | None = None
    bram_avail_g = 0
    if lv is not None:
        for _ in range(max_rollbacks):
            dsp_avail = fpga.dsp_usable - pipe.dsp_sum
            bram_avail = fpga.bram_usable - pipe.bram_sum
            if dsp_avail < 1 or bram_avail < 1:
                if not pipe.n or pipe.all_pf1():
                    break
                pipe.scale_down()
                continue
            target = pipe.batch_latency(bw_p) if pipe.n else None
            pf_cap = max(1, (dsp_avail * alpha) // 2)
            sel = _alg3_sweep(lv, batch, freq, bram_avail, bw_g, dsp_avail,
                              target, pf_cap)
            if sel is None:
                # Even PF=1 doesn't fit: roll the pipeline back.
                if not pipe.n or pipe.all_pf1():
                    break
                pipe.scale_down()
                continue
            bram_avail_g = bram_avail
            break

    # ---- Combine ----------------------------------------------------------
    stages = [StageDesign(packed.majors[i], pipe.cpf[i], pipe.kpf[i],
                          packed.dw, packed.ww) for i in range(pipe.n)]
    pipeline = PipelineDesign(stages, batch)
    gen = None
    lat_g = 0.0
    if sel is not None:
        lvl, st, lat_g = sel
        gen = GenericDesign(int(lv.cpf[lvl]), int(lv.kpf[lvl]), packed.dw,
                            packed.ww, bram_avail_g, bw_g, strategy=st + 1)

    if not stages and gen is None:
        return DesignPoint(rav, pipeline, gen, 0.0, 0.0, 0, 0, 0.0, 0.0,
                           feasible=False)

    rate_p = pipe.throughput(bw_p) if stages else float("inf")
    lat_p = pipe.batch_latency(bw_p) if stages else 0.0
    rate_g = (batch / lat_g if lat_g > 0 else float("inf")) \
        if gen is not None else float("inf")
    rate = min(rate_p, rate_g)
    if not math.isfinite(rate):
        rate = 0.0
    latency_s = lat_p + lat_g

    dsp_used = pipe.dsp_sum + (int(lv.dsp[sel[0]]) if sel is not None else 0)
    bram_used = pipe.bram_sum + (bram_avail_g if sel is not None else 0)
    feasible = dsp_used <= fpga.dsp_usable and bram_used <= fpga.bram_usable

    gops = rate * packed.total_ops / 1e9
    dsp_eff = (gops * 1e9) / (alpha * dsp_used * freq) if dsp_used else 0.0
    return DesignPoint(rav, pipeline, gen, rate, gops, dsp_used, bram_used,
                       dsp_eff, latency_s, feasible)


def _screen_tables(packed: PackedLayers) -> dict:
    """Per-split prefix/suffix tables for the screening relaxation,
    cached on the instance next to the per-split level tables (the key
    is a string, so it can't collide with the int split keys)."""
    try:
        return packed.derived["screen"]
    except KeyError:
        pass
    n = packed.n_major
    pipe_macs = np.zeros(n + 1, dtype=np.float64)
    pipe_macs[1:] = np.cumsum(np.asarray(packed.m_macs, dtype=np.float64))
    macs_np = np.where(packed.is_pool, 0, packed.macs).astype(np.float64)
    tail_macs = np.zeros(packed.n_layers + 1, dtype=np.float64)
    tail_macs[:-1] = np.cumsum(macs_np[::-1])[::-1]
    tail_w = np.zeros(packed.n_layers + 1, dtype=np.float64)
    tail_w[:-1] = np.cumsum(packed.weight_bytes[::-1].astype(np.float64))[::-1]
    t = packed.derived["screen"] = {
        "pipe_macs": pipe_macs,
        "pipe_w": np.asarray(packed.m_wsum, dtype=np.float64),
        "seg_start": np.asarray(packed.seg_start, dtype=np.int64),
        "tail_macs": tail_macs,
        "tail_w": tail_w,
    }
    return t


def screen_rav_batch(net: NetInfo, fpga: FPGASpec,
                     ravs: Sequence[RAV] | np.ndarray,
                     dw: int = 16, ww: int = 16) -> np.ndarray:
    """The batched engine at its capped screening budget: relaxed
    throughput (img/s) for every RAV, fully vectorized — microseconds
    per thousand candidates.

    The relaxation drops everything Algorithms 2+3 iterate over:
    parallelism is the continuous DSP roofline (``pf = dsp * alpha / 2``
    with the split's MACs allocated CTC-proportionally, the fixed point
    Algorithm 2 converges toward), BRAM feasibility and buffer-strategy
    spill are ignored, and memory traffic is the optimistic floor (the
    pipeline's weight+input stream, the generic structure's
    weights-once). The result is a rank proxy, not a bound — e.g. the
    real flow hands the generic structure whatever DSPs the pipeline
    did not consume, while the relaxation charges the full allocation —
    but it preserves enough of the fitness shape over [SP, batch,
    resource splits] to triage candidates: the hyperband engine triages thousands of RAVs
    here, then promotes only the survivors to :func:`evaluate_rav_batch`
    — whose per-candidate cost is ~100x this (Algorithm 2's allocate /
    halve-to-fit / refine loops dominate it at every ``max_rollbacks``
    setting, so capping rollbacks is NOT a usable cheap tier).
    """
    packed = pack_layers(net, dw, ww)
    t = _screen_tables(packed)
    alpha = alpha_for(min(dw, ww))
    freq, bw_total = fpga.freq, fpga.bw_gbps * 1e9

    # Accepts a raw (n, 5) position array (the search driver's screen
    # path — building n RAV objects would dwarf the screen itself) or
    # any RAV sequence; position rows round exactly like
    # SearchSpace.to_rav so both views rank identically.
    if isinstance(ravs, np.ndarray):
        arr = ravs.astype(np.float64, copy=False)
    else:
        arr = np.array([r.as_tuple() for r in ravs], dtype=np.float64)
    if not len(arr):
        return np.zeros(0)
    sp = np.clip(np.round(arr[:, 0]).astype(np.int64), 0, packed.n_major)
    batch = np.maximum(1.0, np.round(arr[:, 1]))
    has_pipe = sp > 0
    dsp_p = np.where(has_pipe, (fpga.dsp_usable * arr[:, 2]).astype(np.int64),
                     0)
    bw_p = np.where(has_pipe, bw_total * arr[:, 4], 0.0)

    with np.errstate(divide="ignore"):
        pf_p = np.maximum(1, dsp_p * alpha // 2).astype(np.float64)
        comp_p = batch * t["pipe_macs"][sp] / (pf_p * freq)
        stream = t["pipe_w"][sp] + batch * packed.ifm0
        mem_p = np.where(bw_p > 0, stream / bw_p,
                         np.where(stream > 0, np.inf, 0.0))
        lat_p = np.where(has_pipe, np.maximum(comp_p, mem_p), 0.0)

        start = t["seg_start"][sp]
        tm, tw = t["tail_macs"][start], t["tail_w"][start]
        has_tail = start < packed.n_layers
        pf_g = np.maximum(
            1, np.maximum(0, fpga.dsp_usable - dsp_p) * alpha // 2
        ).astype(np.float64)
        comp_g = batch * tm / (pf_g * freq)
        bw_g = bw_total - bw_p
        mem_g = np.where(bw_g > 0, tw / bw_g, np.where(tw > 0, np.inf, 0.0))
        lat_g = np.where(has_tail, np.maximum(comp_g, mem_g), 0.0)

    lat = np.maximum(lat_p, lat_g)
    with np.errstate(invalid="ignore"):
        ips = np.where((lat > 0) & np.isfinite(lat), batch / lat, 0.0)
    return ips


def evaluate_rav_batch(net: NetInfo, fpga: FPGASpec, ravs: Sequence[RAV],
                       dw: int = 16, ww: int = 16,
                       max_rollbacks: int = 12) -> list[DesignPoint]:
    """Batched ``evaluate_rav``: the whole population through the array
    kernels, results in input order.

    All candidates sharing a split point share one packed segment and one
    cached pf-ladder/cycle table (built on first touch, kept on the
    :class:`~repro.core.layer_arrays.PackedLayers` instance); each then
    runs the broadcasted Algorithm-3 sweep, with rollbacks diverging per
    candidate. Agreement with the scalar reference is exact on every
    discrete decision and ~1e-9 relative on float objectives (see module
    docstring).
    """
    packed = pack_layers(net, dw, ww)
    return [_eval_rav_fast(packed, fpga, r, max_rollbacks) for r in ravs]
