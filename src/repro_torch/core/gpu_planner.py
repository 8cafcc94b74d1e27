"""DNNExplorer's two-level DSE retargeted to CUDA GPU clusters
(beyond-paper), exactly parallel to :mod:`repro.core.tpu_planner`.

Global optimization (Sec. 7.2 analogue): enumerate the mapping space —
(n_gpus, dp x tp factorization, microbatches, remat) per GPU part — with
the analytic roofline (:mod:`repro.core.gpu_model`) as the fitness,
subject to the HBM-capacity constraint. The space stays small enough to
enumerate exhaustively (the degenerate optimizer, same as the TPU side).

Local optimization (Sec. 7.3 analogue): per plan, remat policy and
microbatch count balance HBM fit against recompute FLOPs — HBM in the
role of BRAM, unchanged from the TPU planner because the balance is a
property of the workload, not the part.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeSpec
from .gpu_model import A100_80G, GPUSpec, analytic_roofline
from .tpu_model import MeshDesc, Roofline, useful_flops
from .tpu_planner import candidate_meshes, factorizations, hbm_per_chip

__all__ = ["GPUPlan", "best_plan", "evaluate_point", "factorizations",
           "plan_arch"]


@dataclasses.dataclass
class GPUPlan:
    arch: str
    shape: str
    gpu: str             # GPUSpec name (a100-40g, a100-80g, h100, ...)
    n_gpus: int
    dp: int
    tp: int
    microbatches: int
    remat: str
    roofline: Roofline
    hbm_per_gpu: float
    fits: bool
    predicted_step_s: float
    mfu: float

    def pretty(self) -> str:
        r = self.roofline
        return (f"{self.arch}/{self.shape} on {self.n_gpus}x{self.gpu}: "
                f"dp={self.dp} tp={self.tp} mb={self.microbatches} "
                f"remat={self.remat} step={self.predicted_step_s:.3g}s "
                f"mfu={self.mfu:.2f} bound={r.bound} "
                f"hbm={self.hbm_per_gpu / 2**30:.1f}GiB fits={self.fits}")


def evaluate_point(cfg: ArchConfig, shape: ShapeSpec, gpus: int, dp: int,
                   tp: int, remat: str, microbatches: int,
                   hw: GPUSpec = A100_80G, calibration=None) -> GPUPlan:
    """Score ONE (mesh x remat x microbatch) mapping on one GPU part with
    the analytic roofline — the single-design evaluation the ``cuda``
    campaign backend loops over, mirroring
    :func:`repro.core.tpu_planner.evaluate_point`.

    ``calibration`` (a :class:`repro.calib.Calibration`, duck-typed via
    ``for_spec``) rescales ``hw`` to measured delivered rates before any
    model math; ``None`` — the default — evaluates against the datasheet
    spec exactly as before."""
    if calibration is not None:
        hw = calibration.for_spec(hw)
    mesh = MeshDesc(gpus, dp, tp)
    rl = analytic_roofline(cfg, shape, mesh, hw)
    if remat != "full" and shape.kind == "train":
        # less recompute: scale the compute term 8ND -> 6ND
        rl = Roofline(rl.t_compute * 0.75, rl.t_memory, rl.t_collective)
    # The static HBM demand model is workload napkin math, shared with the
    # TPU planner; only the capacity it is checked against is GPU-specific.
    hbm = hbm_per_chip(cfg, shape, mesh, remat, microbatches)
    fits = hbm <= hw.hbm_bytes * 0.9
    step = rl.step_time
    # MFU numerator excludes recompute FLOPs (see tpu_model.useful_flops).
    useful = useful_flops(cfg, shape) / gpus / hw.peak_flops
    mfu = min(useful / step, 1.0) if step else 0.0
    return GPUPlan(cfg.name, shape.name, hw.name, gpus, dp, tp, microbatches,
                   remat, rl, hbm, fits, step, mfu)


def plan_arch(cfg: ArchConfig, shape: ShapeSpec, hw: GPUSpec = A100_80G,
              max_gpus: int = 256, objective: str = "throughput_per_gpu"):
    """Enumerate the mesh/remat/microbatch space on one GPU part; return
    plans sorted by the objective (feasible first)."""
    plans: list[GPUPlan] = []
    for gpus, dp, tp in candidate_meshes(max_gpus):
        if shape.global_batch % dp:
            continue
        for remat in (("full", "dots", "none") if shape.kind == "train"
                      else ("none",)):
            for mb in (1, 2, 4, 8):
                if shape.kind != "train" and mb > 1:
                    continue
                plans.append(evaluate_point(cfg, shape, gpus, dp, tp,
                                            remat, mb, hw))
    key = {
        "throughput_per_gpu": lambda p: (-p.fits, p.predicted_step_s * p.n_gpus),
        "latency": lambda p: (-p.fits, p.predicted_step_s),
        "mfu": lambda p: (-p.fits, -p.mfu),
    }[objective]
    plans.sort(key=key)
    return plans


def best_plan(cfg: ArchConfig, shape: ShapeSpec, **kw) -> GPUPlan:
    return plan_arch(cfg, shape, **kw)[0]
