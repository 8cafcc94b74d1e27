"""Analytical model of the *generic structure* (paper Sec. 6.2).

A reusable CPF_g x KPF_g MAC array processes layers ``SP+1..N`` recurrently.
Two on-chip buffer allocation strategies (Sec. 5.3.2) and two dataflows
(input-stationary / weight-stationary) are modelled.

Simplification vs the paper (documented in DESIGN.md): instead of statically
splitting BW into (BW_w, BW_ifm, BW_ofm) and taking max of per-stream
latencies (Eq. 11/13), we use the *optimal* split — proportional to each
stream's total traffic — under which the max of the three stream latencies
equals ``total_traffic / BW``. This is the best case Eq. 11/13 can reach and
keeps the DSE smooth; the traffic amplification terms (G_fm, G_w) are exactly
the paper's.
"""
from __future__ import annotations

import dataclasses
import math

from .hw_specs import alpha_for
from .netinfo import LayerInfo

BRAM_BITS = 18 * 1024

#: Buffer-capacity fractions per strategy (Sec. 5.3.2). Strategy 1 spends
#: BRAM on the feature-map + accumulation buffers (weights live in LUTRAM);
#: strategy 2 carves out a resident weight buffer too. Shared with the
#: batched array kernels in :mod:`repro.core.batch_eval` so the scalar and
#: vectorized models cannot drift apart.
ABUFF_FRAC = {1: 0.25, 2: 0.15}
FMBUFF_FRAC = {1: 0.75, 2: 0.35}
WBUFF_FRAC = {1: 0.0, 2: 0.50}


@dataclasses.dataclass(frozen=True)
class GenericDesign:
    cpf: int
    kpf: int
    dw: int
    ww: int
    bram: int                 # BRAM blocks allocated to the generic structure
    bw_bytes: float           # external-memory bandwidth share, bytes/s
    strategy: int = 1         # 1: BRAM->fm+acc (weights in LUTRAM); 2: BRAM->all
    # Pixel-level parallelism of the MAC array. The paper's generic
    # structure is a GEMV engine (pp=1, Sec. 5.3.1); commercial IPs like the
    # Xilinx DPU additionally unroll over output pixels (pp=8 for B4096),
    # which *underutilizes* on small feature maps — the Fig. 2a effect.
    pixel_par: int = 1

    # -- buffer capacities (bits) -------------------------------------------
    @property
    def _bram_bits(self) -> int:
        return self.bram * BRAM_BITS

    @property
    def cap_abuff(self) -> int:
        # Accumulation buffer: wide/shallow; give it a fixed slice.
        return int(self._bram_bits * ABUFF_FRAC[self.strategy])

    @property
    def cap_fmbuff(self) -> int:
        return int(self._bram_bits * FMBUFF_FRAC[self.strategy])

    @property
    def cap_wbuff(self) -> int:
        # Strategy 1 keeps weights in LUTRAM (a double-buffered tile only).
        return int(self._bram_bits * WBUFF_FRAC[self.strategy])

    # -- resources ------------------------------------------------------------
    def dsp(self) -> int:
        alpha = alpha_for(min(self.dw, self.ww))
        return max(1, (2 * self.pixel_par * self.cpf * self.kpf) // alpha)

    # -- per-layer latency (seconds, one image) -------------------------------
    def _l_comp(self, l: LayerInfo, freq: float) -> float:
        """Eq. 6 with MAC-array *utilization* made explicit: a generic
        CPF x KPF array runs ceil(C/CPF)*ceil(K/KPF) passes per output
        pixel, so layers with C < CPF (e.g. the 3-channel input layer) or
        K < KPF waste lanes. This tail effect is exactly the DSP-efficiency
        loss of paradigm-A accelerators on early layers (paper Fig. 2a)."""
        pix = math.ceil(l.h * l.w / self.pixel_par)
        if l.kind == "dwconv":
            # Depthwise: each output channel consumes only its own input
            # channel — only the CPF dimension of the array can be used.
            cycles = pix * l.r * l.s * math.ceil(l.c / self.cpf)
        else:
            cin = l.c // l.groups
            cycles = (pix * l.r * l.s
                      * math.ceil(cin / self.cpf) * math.ceil(l.k / self.kpf))
        return cycles / freq

    def g_fm(self, l: LayerInfo, batch: int = 1) -> int:
        """Eq. 5 — output fm groups forced by the accumulation buffer
        (ping-pong halves the usable capacity). A batch of frames is
        grouped together so weight fetches amortize across the batch."""
        need = batch * l.h * l.w * l.k * self.dw
        return max(1, math.ceil(need / max(1, self.cap_abuff // 2)))

    def g_w(self, l: LayerInfo) -> int:
        """Eq. 12 — weight groups along K forced by the weight buffer."""
        if self.strategy == 1:
            return 1
        need = l.r * l.s * (l.c // l.groups) * l.k * self.ww
        return max(1, math.ceil(need / max(1, self.cap_wbuff // 2)))

    def _fm_fits(self, l: LayerInfo, batch: int = 1) -> bool:
        need = batch * (l.ifm_bytes(self.dw) + l.ofm_bytes(self.dw)) * 8
        return need <= self.cap_fmbuff // 2

    def layer_latency(self, l: LayerInfo, freq: float, batch: int = 1) -> float:
        """max(compute, memory) for a *batch* of frames, with the dataflow
        that minimizes external traffic (IS vs WS chosen per layer, as the
        paper's Algorithm 3 line 9 does under strategy 2)."""
        if l.kind == "pool":
            # Pool runs on the functional sub-module, overlapped with MACs;
            # only fm traffic if it spills.
            if self._fm_fits(l, batch):
                return 0.0
            if self.bw_bytes <= 0:
                return float("inf")
            return batch * (l.ifm_bytes(self.dw) + l.ofm_bytes(self.dw)) / self.bw_bytes

        l_comp = batch * self._l_comp(l, freq)
        w_bytes = l.weight_bytes(self.ww)
        ifm, ofm = l.ifm_bytes(self.dw), l.ofm_bytes(self.dw)

        if self._fm_fits(l, batch):
            # Eq. 8 regime: fm stays on chip; weights stream G_fm times.
            traffic_is = w_bytes * self.g_fm(l, batch)
        else:
            # Eq. 11 regime: line-partitioned fm swaps through ext. memory too.
            traffic_is = w_bytes * self.g_fm(l, batch) + batch * (ifm + ofm)

        candidates = [traffic_is]
        if self.strategy == 2:
            # Eq. 13 (WS): weights resident; ifm re-streamed per weight group.
            traffic_ws = w_bytes + batch * (ifm * self.g_w(l) + ofm)
            candidates.append(traffic_ws)

        l_mem = min(candidates) / self.bw_bytes if self.bw_bytes > 0 else float("inf")
        return max(l_comp, l_mem)

    def segment_latency(self, layers: list[LayerInfo], freq: float,
                        batch: int = 1) -> float:
        """Recurrent latency for a batch over layers SP+1..N."""
        return sum(self.layer_latency(l, freq, batch) for l in layers)


def best_generic(layers: list[LayerInfo], cpf: int, kpf: int, dw: int, ww: int,
                 bram: int, bw_bytes: float, freq: float,
                 batch: int = 1) -> GenericDesign:
    """Evaluate both buffer-allocation strategies, return the faster."""
    cands = [GenericDesign(cpf, kpf, dw, ww, bram, bw_bytes, strategy=s)
             for s in (1, 2)]
    return min(cands, key=lambda g: g.segment_latency(layers, freq, batch))
