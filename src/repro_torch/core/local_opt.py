"""Local optimization + full design-point evaluation (paper Sec. 7.3).

Given an RAV from the global optimizer, this module runs:

* Algorithm 2 — CTC-based parallelism allocation for the pipeline half
  (in ``pipeline_model.design_pipeline``), and
* Algorithm 3 — balance-oriented growth of the generic structure:
  double PF_g until the generic half keeps up with the pipeline half
  (``L_g <= L_p^max``), rolling the pipeline back if resources run out.

The result is a :class:`DesignPoint` with throughput, GOP/s, DSP efficiency
and resource usage — the fitness the PSO sees.
"""
from __future__ import annotations

import dataclasses
import math

from .generic_model import GenericDesign, best_generic
from .hw_specs import FPGASpec, alpha_for
from .netinfo import LayerInfo, NetInfo
from .pipeline_model import (PipelineDesign, design_pipeline, scale_down,
                             split_pf)


@dataclasses.dataclass(frozen=True)
class RAV:
    """Resource Allocation Vector (Eq. 2): task split + resources for the
    pipeline structure; the generic structure gets the complement."""

    sp: int          # split-point: #major layers in the pipeline half
    batch: int
    dsp_frac: float  # fraction of usable DSPs given to the pipeline half
    bram_frac: float
    bw_frac: float

    def as_tuple(self) -> tuple:
        return (self.sp, self.batch, self.dsp_frac, self.bram_frac, self.bw_frac)


@dataclasses.dataclass
class DesignPoint:
    rav: RAV
    pipeline: PipelineDesign
    generic: GenericDesign | None
    throughput_ips: float
    gops: float
    dsp_used: int
    bram_used: int
    dsp_eff: float
    latency_s: float = 0.0   # end-to-end batch latency (pipeline + generic)
    feasible: bool = True

    @property
    def fitness(self) -> float:
        return self.throughput_ips if self.feasible else 0.0


def _segment_after(net: NetInfo, sp: int) -> list[LayerInfo]:
    """All layers (incl. pools) after the sp-th major layer. Always a
    contiguous suffix of ``net.layers`` — ``layer_arrays.pack_layers``
    exploits that to index any split's segment in O(1) (identity is
    regression-tested in ``tests/test_batch_eval.py``)."""
    majors = 0
    out: list[LayerInfo] = []
    for l in net.layers:
        if l.kind != "pool":
            majors += 1
        # A pool directly after major layer <= sp is fused into that stage.
        if majors > sp:
            out.append(l)
    return out


def evaluate_rav(net: NetInfo, fpga: FPGASpec, rav: RAV, dw: int = 16,
                 ww: int = 16, max_rollbacks: int = 12,
                 calibration=None) -> DesignPoint:
    """Algorithms 2+3 for one RAV. Deterministic, pure.

    This is the scalar *reference* implementation: readable, paper-shaped,
    one layer at a time. The PSO's population fitness goes through the
    batched array-kernel twin (:func:`repro.core.batch_eval.
    evaluate_rav_batch`), which must agree with this function on every
    discrete decision and to <=1e-9 relative on float objectives
    (``tests/test_batch_eval.py`` enforces it); the winning RAV is always
    re-evaluated here.

    ``calibration`` (a :class:`repro.calib.Calibration`, duck-typed via
    ``for_spec``) rescales the part's clock and bandwidth to measured
    delivered rates before anything is modeled; ``None`` — the default —
    evaluates against the datasheet spec exactly as before. Callers that
    batch-evaluate (the PSO) apply the same rescale once, up front, via
    ``calibration.for_spec`` so the scalar and batched twins stay in
    lockstep."""
    if calibration is not None:
        fpga = calibration.for_spec(fpga)
    freq = fpga.freq
    majors = net.major_layers
    sp = max(0, min(rav.sp, len(majors)))
    pipe_layers = list(majors[:sp])
    gen_layers = _segment_after(net, sp)

    dsp_p = int(fpga.dsp_usable * rav.dsp_frac) if sp else 0
    bram_p = int(fpga.bram_usable * rav.bram_frac) if sp else 0
    bw_p = fpga.bw_gbps * 1e9 * rav.bw_frac if sp else 0.0
    bw_g = fpga.bw_gbps * 1e9 - bw_p

    pipe = design_pipeline(pipe_layers, dsp_p, bram_p, bw_p, freq, dw, ww,
                           rav.batch)

    # ---- Algorithm 3: grow the generic structure until balanced ----------
    gen: GenericDesign | None = None
    if gen_layers:
        for _ in range(max_rollbacks):
            dsp_avail = fpga.dsp_usable - pipe.dsp()
            bram_avail = fpga.bram_usable - pipe.bram()
            if dsp_avail < 1 or bram_avail < 1:
                if not pipe.stages or all(s.pf == 1 for s in pipe.stages):
                    break
                pipe = scale_down(pipe)
                continue
            target = pipe.batch_latency(freq, bw_p) if pipe.stages else None
            alpha = alpha_for(min(dw, ww))
            pf_cap = max(1, (dsp_avail * alpha) // 2)
            c_max = max(l.c for l in gen_layers)
            k_max = max(l.k for l in gen_layers)
            pf = 1
            gen = None
            while True:
                cpf, kpf = split_pf(pf, c_max, k_max)
                cand = best_generic(gen_layers, cpf, kpf, dw, ww, bram_avail,
                                    bw_g, freq, rav.batch)
                if cand.dsp() > dsp_avail:
                    break
                gen = cand
                lat = gen.segment_latency(gen_layers, freq, rav.batch)
                if target is not None and lat <= target:
                    break  # balanced (Alg. 3 line 5 condition met)
                if pf >= pf_cap or cpf * kpf < pf:
                    break  # parallelism saturated
                pf *= 2
            if gen is None:
                # Even PF=1 doesn't fit: roll the pipeline back.
                if not pipe.stages or all(s.pf == 1 for s in pipe.stages):
                    break
                pipe = scale_down(pipe)
                continue
            break

    # ---- Combine ----------------------------------------------------------
    if not pipe.stages and gen is None:
        return DesignPoint(rav, pipe, gen, 0.0, 0.0, 0, 0, 0.0, 0.0,
                           feasible=False)

    rate_p = pipe.throughput_ips(freq, bw_p) if pipe.stages else float("inf")
    lat_p = pipe.batch_latency(freq, bw_p) if pipe.stages else 0.0
    if gen is not None:
        lat_g = gen.segment_latency(gen_layers, freq, rav.batch)
        rate_g = rav.batch / lat_g if lat_g > 0 else float("inf")
    else:
        lat_g = 0.0
        rate_g = float("inf")
    rate = min(rate_p, rate_g)
    if not math.isfinite(rate):
        rate = 0.0
    # One batch crosses both halves back-to-back (steady-state throughput
    # overlaps them, first-batch latency does not).
    latency_s = lat_p + lat_g

    dsp_used = pipe.dsp() + (gen.dsp() if gen else 0)
    bram_used = pipe.bram() + (gen.bram if gen else 0)
    feasible = dsp_used <= fpga.dsp_usable and bram_used <= fpga.bram_usable

    gops = rate * net.total_ops / 1e9
    alpha = alpha_for(min(dw, ww))
    dsp_eff = (gops * 1e9) / (alpha * dsp_used * freq) if dsp_used else 0.0
    return DesignPoint(rav, pipe, gen, rate, gops, dsp_used, bram_used,
                       dsp_eff, latency_s, feasible)


# ---------------------------------------------------------------------------
# Paper baselines (Sec. 8 comparisons), built from the same primitives
# ---------------------------------------------------------------------------


def dnnbuilder_design(net: NetInfo, fpga: FPGASpec, dw: int = 16, ww: int = 16,
                      batch: int = 1) -> DesignPoint:
    """Paradigm B baseline: pure layer-wise pipeline (SP = all layers)."""
    rav = RAV(len(net.major_layers), batch, 1.0, 1.0, 1.0)
    return evaluate_rav(net, fpga, rav, dw, ww)


def generic_only_design(net: NetInfo, fpga: FPGASpec, dw: int = 16,
                        ww: int = 16, batch: int = 1) -> DesignPoint:
    """Paradigm A baseline: one reusable GEMV compute unit (SP = 0),
    analytical proxy for HybridDNN."""
    rav = RAV(0, batch, 0.0, 0.0, 0.0)
    return evaluate_rav(net, fpga, rav, dw, ww)


def dpu_proxy_design(net: NetInfo, fpga: FPGASpec, dw: int = 16, ww: int = 16,
                     batch: int = 1, pixel_par: int = 8, cpf: int = 16,
                     kpf: int = 32) -> DesignPoint:
    """Analytical proxy for a fixed-geometry commercial IP (Xilinx DPU
    B4096-like: 8 pixel x 16 input-ch x 32 output-ch MAC cube). The fixed
    pixel unroll underutilizes on small feature maps — Fig. 2a."""
    gen_layers = list(net.layers)
    gen = GenericDesign(cpf, kpf, dw, ww, fpga.bram_usable,
                        fpga.bw_gbps * 1e9, strategy=1, pixel_par=pixel_par)
    lat = gen.segment_latency(gen_layers, fpga.freq, batch)
    rate = batch / lat if lat > 0 else 0.0
    gops = rate * net.total_ops / 1e9
    alpha = alpha_for(min(dw, ww))
    dsp_eff = (gops * 1e9) / (alpha * gen.dsp() * fpga.freq) if gen.dsp() else 0.0
    rav = RAV(0, batch, 0.0, 0.0, 0.0)
    return DesignPoint(rav, PipelineDesign([], batch), gen, rate, gops,
                       gen.dsp(), gen.bram, dsp_eff, lat)
