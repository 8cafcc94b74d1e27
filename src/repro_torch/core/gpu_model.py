"""Analytical GPU cost model — the paper's *Accelerator Modeling* step
(Sec. 6) retargeted a second time, from FPGA/TPU to CUDA GPUs.

Same max-of-terms structure as :mod:`repro.core.tpu_model` (the paper's
latency law L = max(L_comp, L_w*G_fm, L_ifm, L_ofm), Eq. 11): per
(arch x shape x mesh) the step time is the max of

* **SM compute** — useful model FLOPs against the tensor-core peak;
* **HBM** — the napkin per-GPU traffic model (weight streams, activation
  round-trips, optimizer state, KV cache) against HBM bandwidth;
* **NVLink/IB** — the napkin per-GPU collective traffic against the
  interconnect. GPUs have a two-tier fabric: NVLink inside a
  ``node_size`` NVSwitch domain, InfiniBand per GPU across nodes. Ring
  collectives spanning nodes are gated by the slowest hop, so meshes
  larger than one node pay the IB rate on every collective — the
  conservative (weakest-link) approximation.

The per-token FLOP and per-step byte models are device-family-agnostic
(they describe the WORKLOAD, not the part), so they are shared with
:mod:`repro.core.tpu_model` verbatim; only the denominators — which
hardware ceiling each term divides by — are GPU-specific.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec
from .hw_specs import A100_40G, A100_80G, GPUS, H100, GPUSpec
from .tpu_model import (MeshDesc, Roofline, model_collective_bytes,
                        model_flops, model_hbm_bytes)

__all__ = ["A100_40G", "A100_80G", "GPUS", "H100", "GPUSpec", "MeshDesc",
           "Roofline", "NVLINK_EFFICIENCY", "analytic_roofline",
           "collective_bw", "model_flops"]

#: Achievable fraction of the link peak for ring/tree collectives (NCCL
#: bus bandwidth vs datasheet rate; protocol + hierarchy overheads).
NVLINK_EFFICIENCY = 0.8


def collective_bw(mesh: MeshDesc, hw: GPUSpec) -> float:
    """Effective per-GPU collective bandwidth for a mesh: NVLink while the
    mesh fits one NVSwitch domain, the per-GPU IB rate once it spans
    nodes (the cross-node hop gates every ring that crosses it)."""
    link = hw.nvlink_bw if mesh.n_chips <= hw.node_size else hw.ib_bw
    return NVLINK_EFFICIENCY * link


def analytic_roofline(cfg: ArchConfig, shape: ShapeSpec, mesh: MeshDesc,
                      hw: GPUSpec = A100_80G) -> Roofline:
    """SM-compute vs HBM vs NVLink/IB roofline for one (arch, shape, mesh)
    on one GPU part — the GPU analogue of
    :func:`repro.core.tpu_model.analytic_roofline`."""
    return Roofline(
        t_compute=model_flops(cfg, shape) / mesh.n_chips / hw.peak_flops,
        t_memory=model_hbm_bytes(cfg, shape, mesh) / hw.hbm_bw,
        t_collective=model_collective_bytes(cfg, shape, mesh)
        / collective_bw(mesh, hw),
    )
