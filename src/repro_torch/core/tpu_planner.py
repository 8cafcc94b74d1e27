"""DNNExplorer's two-level DSE retargeted to TPU meshes (beyond-paper).

Global optimization (Sec. 7.2 analogue): search the resource-allocation
vector — here (n_chips, dp x tp factorization, microbatches, remat) — with
the analytic roofline model (tpu_model) as the fitness, subject to the
HBM-capacity constraint. The FPGA version searches DSP/BRAM/BW splits with
PSO because the space is ~10^6 points; the TPU mapping space is small
enough (<=200 points) to enumerate exhaustively, which is the same global
step with a degenerate optimizer — PSO remains available via
``use_pso=True`` for extended spaces.

Local optimization (Sec. 7.3 analogue): per plan, pick the remat policy and
microbatch count that balance HBM fit against recompute FLOPs — the
balance-oriented step (Algorithm 3) with HBM in the role of BRAM.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig, ShapeSpec
from .hw_specs import TPU_V5E, TPUSpec
from .tpu_model import (MeshDesc, Roofline, analytic_roofline,
                        kv_cache_bytes, useful_flops)


@dataclasses.dataclass
class Plan:
    arch: str
    shape: str
    n_chips: int
    dp: int
    tp: int
    microbatches: int
    remat: str
    roofline: Roofline
    hbm_per_chip: float
    fits: bool
    predicted_step_s: float
    mfu: float

    def pretty(self) -> str:
        r = self.roofline
        return (f"{self.arch}/{self.shape}: chips={self.n_chips} "
                f"dp={self.dp} tp={self.tp} mb={self.microbatches} "
                f"remat={self.remat} step={self.predicted_step_s:.3g}s "
                f"mfu={self.mfu:.2f} bound={r.bound} "
                f"hbm={self.hbm_per_chip / 2**30:.1f}GiB fits={self.fits}")


def hbm_per_chip(cfg: ArchConfig, shape: ShapeSpec, mesh: MeshDesc,
                 remat: str, microbatches: int) -> float:
    """Static HBM demand: param + optimizer shards, activations, cache."""
    p = cfg.param_count()
    static = p * (4.0 + 8.0) / mesh.n_chips if shape.kind == "train" \
        else p * 2.0 / mesh.n_chips
    act = 0.0
    if shape.kind != "decode":
        tokens_dev = shape.global_batch * shape.seq_len / mesh.dp / microbatches
        per_layer = tokens_dev * cfg.d_model * 2.0 / max(mesh.tp // 4, 1)
        layers_live = cfg.n_layers if remat == "none" else (
            math.sqrt(cfg.n_layers) if remat == "dots" else 1.0)
        act = per_layer * max(layers_live, 1.0) * (4.0 if remat == "none" else 8.0)
    cache = kv_cache_bytes(cfg, shape) / mesh.n_chips if shape.kind == "decode" else 0.0
    return static + act + cache


def factorizations(chips: int):
    """All power-of-two (dp, tp) splits of a chip count, tp ascending.
    The chip count itself must be a positive power of two — anything else
    would silently yield splits with dp * tp != chips."""
    if chips <= 0 or chips & (chips - 1):
        raise ValueError(f"chips must be a positive power of two, "
                         f"got {chips}")
    tp = 1
    while tp <= chips:
        yield chips // tp, tp
        tp *= 2


def candidate_meshes(max_chips: int = 256):
    chips = 8
    while chips <= max_chips:
        for dp, tp in factorizations(chips):
            yield chips, dp, tp
        chips *= 2


def evaluate_point(cfg: ArchConfig, shape: ShapeSpec, chips: int, dp: int,
                   tp: int, remat: str, microbatches: int,
                   hw: TPUSpec = TPU_V5E, calibration=None) -> Plan:
    """Score ONE (mesh x remat x microbatch) mapping with the analytic
    roofline — the single-design evaluation both :func:`plan_arch` and the
    ``repro.dse`` TPU campaign backend loop over.

    ``calibration`` (a :class:`repro.calib.Calibration`, duck-typed via
    ``for_spec``) rescales ``hw`` to measured delivered rates before any
    model math; ``None`` — the default — evaluates against the datasheet
    spec exactly as before."""
    if calibration is not None:
        hw = calibration.for_spec(hw)
    mesh = MeshDesc(chips, dp, tp)
    rl = analytic_roofline(cfg, shape, mesh, hw)
    if remat != "full" and shape.kind == "train":
        # less recompute: scale the compute term 8ND -> 6ND
        rl = Roofline(rl.t_compute * 0.75, rl.t_memory, rl.t_collective)
    hbm = hbm_per_chip(cfg, shape, mesh, remat, microbatches)
    fits = hbm <= hw.hbm_bytes * 0.9
    step = rl.step_time
    # MFU numerator excludes recompute FLOPs (see tpu_model.useful_flops):
    # full-remat compute-bound designs top out at 0.75, not 1.0.
    useful = useful_flops(cfg, shape) / chips / hw.peak_flops
    mfu = min(useful / step, 1.0) if step else 0.0
    return Plan(cfg.name, shape.name, chips, dp, tp, microbatches, remat,
                rl, hbm, fits, step, mfu)


def plan_arch(cfg: ArchConfig, shape: ShapeSpec, hw: TPUSpec = TPU_V5E,
              max_chips: int = 256, objective: str = "throughput_per_chip"):
    """Enumerate the mesh/remat/microbatch space; return plans sorted by
    the objective (feasible first)."""
    plans: list[Plan] = []
    for chips, dp, tp in candidate_meshes(max_chips):
        if shape.global_batch % dp:
            continue
        for remat in (("full", "dots", "none") if shape.kind == "train"
                      else ("none",)):
            for mb in (1, 2, 4, 8):
                if shape.kind != "train" and mb > 1:
                    continue
                plans.append(evaluate_point(cfg, shape, chips, dp, tp,
                                            remat, mb, hw))
    key = {
        "throughput_per_chip": lambda p: (-p.fits, p.predicted_step_s * p.n_chips),
        "latency": lambda p: (-p.fits, p.predicted_step_s),
        "mfu": lambda p: (-p.fits, -p.mfu),
    }[objective]
    plans.sort(key=key)
    return plans


def best_plan(cfg: ArchConfig, shape: ShapeSpec, **kw) -> Plan:
    return plan_arch(cfg, shape, **kw)[0]
