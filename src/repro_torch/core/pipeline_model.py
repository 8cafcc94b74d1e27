"""Analytical model of the *pipeline structure* (paper Sec. 6.1).

One dedicated stage per layer ``1..SP`` with two-dim parallelism
``(CPF_i, KPF_i)``; fine-grained (column-based) pipelining from DNNBuilder.

Latency (Eq. 3):   L_i = H*W*R*S*C*K / (CPF_i * KPF_i * FREQ)
Throughput (Eq. 4): Batch / max(L_i over a batch)

Batching: stages stream Batch frames back-to-back, so compute time scales
with Batch while the weight stream is fetched once per batch (DNNBuilder's
weight-bandwidth amortization — this is what makes Table 4's small-input
cases jump 4.6x at Batch=8: at 32x32 the weights dominate traffic and
Batch=1 is bandwidth-bound at 42% DSP efficiency).
"""
from __future__ import annotations

import dataclasses
import math

from .hw_specs import alpha_for
from .netinfo import LayerInfo

BRAM_BITS = 18 * 1024


def _pow2_floor(x: float) -> int:
    return 1 << max(0, int(math.floor(math.log2(max(x, 1)))))


def stage_dsp(pf: int, alpha: int) -> int:
    """DSPs for ``pf`` MACs/cycle at ``alpha`` MAC-ops per DSP (Eq. 1).
    Shared with :mod:`repro.core.batch_eval` so both paths use one formula."""
    return max(1, (2 * pf) // alpha)


def stage_col_ceil(l: LayerInfo, dw: int) -> int:
    """BRAM blocks demanded by a stage's column/row line buffer alone."""
    col_bits = l.c * l.h * l.stride * (l.s + 1) * dw
    return math.ceil(col_bits / BRAM_BITS)


def stage_bram(cpf: int, kpf: int, dw: int, ww: int, col_ceil: int,
               rs: int) -> int:
    """Column/row buffer + ping-pong weight buffer (Sec. 5.2.2); ``rs`` is
    the stage's kernel area R*S, ``col_ceil`` its :func:`stage_col_ceil`.
    BRAM ports are <=36b wide: a CPF-wide parallel read needs that many
    physical blocks even if shallow."""
    w_bits = 2 * rs * cpf * kpf * ww
    min_banks = max(1, math.ceil(cpf * dw / 36))
    return max(min_banks, col_ceil) + max(1, math.ceil(w_bits / BRAM_BITS))


def split_pf(pf: int, c: int, k: int) -> tuple[int, int]:
    """Factor a parallelism budget into (CPF, KPF), both powers of two,
    CPF<=C, KPF<=K; near-square split balances PE broadcast fan-out
    against accumulation fan-in."""
    pf = max(1, _pow2_floor(pf))
    cpf = min(_pow2_floor(math.sqrt(pf)), _pow2_floor(c))
    kpf = min(pf // cpf, _pow2_floor(k))
    cpf = min(pf // kpf, _pow2_floor(c))  # regrow CPF if KPF clipped by K
    return max(1, cpf), max(1, kpf)


@dataclasses.dataclass(frozen=True)
class StageDesign:
    layer: LayerInfo
    cpf: int
    kpf: int
    dw: int  # activation bits
    ww: int  # weight bits

    @property
    def pf(self) -> int:
        return self.cpf * self.kpf

    def comp_latency(self, freq: float) -> float:
        """Eq. 3 — cycles = MACs / (CPF*KPF), one frame."""
        return self.layer.macs / (self.pf * freq)

    def dsp(self) -> int:
        """DSPs for CPF*KPF MACs/cycle; 8-bit packs two MACs per DSP."""
        return stage_dsp(self.pf, alpha_for(min(self.dw, self.ww)))

    def bram(self) -> int:
        """Column/row buffer + ping-pong weight buffer (Sec. 5.2.2)."""
        l = self.layer
        return stage_bram(self.cpf, self.kpf, self.dw, self.ww,
                          stage_col_ceil(l, self.dw), l.r * l.s)


@dataclasses.dataclass
class PipelineDesign:
    stages: list[StageDesign]
    batch: int = 1

    def max_comp_latency(self, freq: float) -> float:
        return max((s.comp_latency(freq) for s in self.stages), default=0.0)

    def stream_bytes(self) -> float:
        """External traffic per batch: all stage weights once + Batch input frames."""
        if not self.stages:
            return 0.0
        w = sum(s.layer.weight_bytes(s.ww) for s in self.stages)
        ifm = self.stages[0].layer.ifm_bytes(self.stages[0].dw)
        return w + self.batch * ifm

    def batch_latency(self, freq: float, bw_bytes: float) -> float:
        """Steady-state time per batch = max(compute roofline, memory roofline)."""
        if not self.stages:
            return 0.0
        l_comp = self.batch * self.max_comp_latency(freq)
        l_mem = self.stream_bytes() / bw_bytes if bw_bytes > 0 else float("inf")
        return max(l_comp, l_mem)

    def throughput_ips(self, freq: float, bw_bytes: float) -> float:
        """Eq. 4 — frames/s."""
        if not self.stages:
            return float("inf")
        lat = self.batch_latency(freq, bw_bytes)
        return self.batch / lat if lat > 0 else 0.0

    def dsp(self) -> int:
        return sum(s.dsp() for s in self.stages)

    def bram(self) -> int:
        return sum(s.bram() for s in self.stages)


def ctc_allocate(layers: list[LayerInfo], bw_bytes: float, freq: float,
                 dw: int, ww: int) -> list[int]:
    """Algorithm 2 lines 4-6: CTC-based parallelism allocation.

    Gives every stage the same latency  T = total_bytes / BW_p  (perfect
    bandwidth match): PF_i = OP_i * BW_p / BW_total_norm / FREQ, with
    BW_total_norm = sum_j OP_j / CTC_j (= total weight-stream bytes)."""
    bw_norm_total = sum(l.weight_bytes(ww) for l in layers)
    if bw_norm_total == 0 or bw_bytes <= 0:
        return [1] * len(layers)
    pfs = []
    for l in layers:
        pf = l.macs * bw_bytes / bw_norm_total / freq
        pfs.append(max(1, _pow2_floor(pf)))
    return pfs


def scale_down(design: PipelineDesign) -> PipelineDesign:
    """Algorithm 2 line 9 / Algorithm 3 line 13: PF_i = max(1, PF_i/2)."""
    stages = [StageDesign(s.layer, *split_pf(max(1, s.pf // 2), s.layer.c, s.layer.k),
                          s.dw, s.ww) for s in design.stages]
    return PipelineDesign(stages, design.batch)


def design_pipeline(layers: list[LayerInfo], dsp_cap: int, bram_cap: int,
                    bw_bytes: float, freq: float, dw: int, ww: int,
                    batch: int = 1) -> PipelineDesign:
    """Algorithm 2: allocate PFs by CTC, then halve until resources fit."""
    pfs = ctc_allocate(layers, bw_bytes, freq, dw, ww)
    stages = [StageDesign(l, *split_pf(pf, l.c, l.k), dw, ww)
              for l, pf in zip(layers, pfs)]
    design = PipelineDesign(stages, batch)
    while design.stages and (design.dsp() > dsp_cap or design.bram() > bram_cap):
        if all(s.pf == 1 for s in design.stages):
            break
        design = scale_down(design)

    # Refinement: the pow2 floor can leave the bottleneck stage up to 2x
    # slower than its CTC-ideal latency; greedily double the slowest stage's
    # PF while resources allow (DNNBuilder's fine-grained allocation).
    while design.stages:
        i = max(range(len(design.stages)),
                key=lambda j: design.stages[j].comp_latency(freq))
        s = design.stages[i]
        if s.pf >= s.layer.c * s.layer.k:
            break
        bumped = StageDesign(s.layer, *split_pf(s.pf * 2, s.layer.c, s.layer.k),
                             dw, ww)
        if bumped.pf <= s.pf:
            break
        trial = PipelineDesign(design.stages[:i] + [bumped] + design.stages[i + 1:],
                               batch)
        if trial.dsp() > dsp_cap or trial.bram() > bram_cap:
            break
        design = trial
    return design
