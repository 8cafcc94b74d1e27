"""Analytical TPU cost model — the paper's *Accelerator Modeling* step
(Sec. 6) retargeted from FPGA to TPU v5e.

The paper's latency law L = max(L_comp, L_w*G_fm, L_ifm, L_ofm) (Eq. 11)
IS a roofline: compute term vs weight-stream term vs feature-map terms.
Here the same three families of terms are derived per (arch x shape x
mesh): MXU compute, HBM traffic, ICI collective traffic. They drive
(a) the §Roofline report, (b) the DSE fitness in tpu_planner, and (c) the
napkin math in the §Perf hillclimb — and are validated against the
dry-run's compiled HLO (the analogue of the paper's board measurements,
Figs. 7/8).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeSpec
from .hw_specs import TPU_V5E, TPUSpec


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    n_chips: int
    dp: int          # data-parallel ways (incl. pod axis)
    tp: int          # model/tensor-parallel ways

    @classmethod
    def single_pod(cls):
        return cls(256, 16, 16)

    @classmethod
    def multi_pod(cls):
        return cls(512, 32, 16)


def _matmul_params(cfg: ArchConfig) -> float:
    """Params participating in per-token matmuls (embedding *gather* is
    free; the lm_head matmul is not)."""
    n = cfg.active_param_count()
    n -= cfg.vocab * cfg.d_model  # the gather-only embedding matrix
    return float(n)


def _attn_flops_per_token(cfg: ArchConfig, s_ctx: int, causal: bool = True) -> float:
    """QK^T + PV flops per token at context length s_ctx (per layer set)."""
    if cfg.family == "ssm":
        # mLSTM chunked: ~2 matmul-pairs of (chunk x hd) per token per head
        q = cfg.ssm.chunk if cfg.ssm else 256
        return 4.0 * cfg.n_layers * q * cfg.d_model
    ctx = min(s_ctx, cfg.window) if cfg.window else s_ctx
    eff = ctx / 2 if causal and not cfg.window else ctx
    d_attn = cfg.n_heads * cfg.head_dim
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // max(cfg.shared_attn_every, 1)
        # + SSD chunk work for the mamba layers
        q = cfg.ssm.chunk if cfg.ssm else 256
        ssd = 4.0 * cfg.n_layers * q * (cfg.ssm.expansion * cfg.d_model)
        return 4.0 * n_attn_layers * eff * d_attn + ssd
    return 4.0 * n_attn_layers * eff * d_attn


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Useful (MODEL) FLOPs per global step: 6*N*D for train (+remat -> 8),
    2*N*D for prefill, 2*N_active per decoded token + attention reads."""
    n_mat = _matmul_params(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * s
        per_tok = 2.0 * n_mat + _attn_flops_per_token(cfg, s)
        return 4.0 * tokens * per_tok  # fwd + full-remat recompute + 2x bwd
    if shape.kind == "prefill":
        tokens = b * s
        per_tok = 2.0 * n_mat + _attn_flops_per_token(cfg, s)
        return tokens * per_tok
    # decode: one token per sequence against an s-long context
    per_tok = 2.0 * n_mat
    if cfg.family in ("ssm", "hybrid"):
        # state update/readout, O(1) in s
        ssm = cfg.ssm
        d_in = ssm.expansion * cfg.d_model if ssm else cfg.d_model
        per_tok += 4.0 * cfg.n_layers * d_in * (ssm.state_dim if ssm else 64)
        if cfg.family == "hybrid":
            n_attn = cfg.n_layers // max(cfg.shared_attn_every, 1)
            per_tok += 4.0 * n_attn * s * cfg.n_kv * cfg.head_dim
    else:
        ctx = min(s, cfg.window) if cfg.window else s
        per_tok += 4.0 * cfg.n_layers * ctx * cfg.n_kv * cfg.head_dim
    return b * per_tok


def useful_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL FLOPs per step that do useful work: the standard MFU
    numerator. Train excludes the full-remat recompute pass —
    :func:`model_flops` counts fwd + recompute + 2x bwd (8ND-style), of
    which 6ND is model work — so a compute-bound full-remat design reports
    MFU 0.75, not a fictitious 1.0, and the DSE's normalized delivered
    TFLOP/s never exceeds what the hardware could usefully deliver."""
    f = model_flops(cfg, shape)
    return 0.75 * f if shape.kind == "train" else f


def kv_cache_bytes(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Global decode-state bytes (KV cache or recurrent state)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        hd = cfg.d_model // cfg.n_heads
        return float(b * cfg.n_layers * cfg.n_heads * (hd * hd + hd + 1) * 4)
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        d_in = ssm.expansion * cfg.d_model
        state = b * cfg.n_layers * (d_in // ssm.head_dim) * ssm.head_dim * ssm.state_dim * 4
        n_groups = cfg.n_layers // cfg.shared_attn_every
        kv = b * n_groups * s * cfg.n_kv * cfg.head_dim * 2 * 2
        return float(state + kv)
    slots = min(s, cfg.window) if cfg.window else s
    layers = cfg.n_layers
    return float(b * layers * slots * cfg.n_kv * cfg.head_dim * 2 * 2)


def model_hbm_bytes(cfg: ArchConfig, shape: ShapeSpec, mesh: MeshDesc) -> float:
    """Per-chip HBM traffic per step (napkin model).

    Weights: each chip streams its TP shard of the active params in bf16,
    once per pass (train: fwd + remat + bwd = 3 passes).
    Activations: ~10 residual-stream-sized tensors per block round-trip.
    Optimizer: fp32 params+mu+nu read & written (train only).
    Decode adds the chip's slice of the KV cache per token.
    """
    n_mat = _matmul_params(cfg)
    w_shard = 2.0 * n_mat / mesh.tp
    tokens_dev = shape.global_batch * shape.seq_len / mesh.dp
    act = 10.0 * cfg.n_layers * tokens_dev * cfg.d_model * 2.0
    if shape.kind == "train":
        opt = 20.0 * 4.0 * cfg.param_count() / mesh.n_chips
        return 3.0 * w_shard + act + opt
    if shape.kind == "prefill":
        return w_shard + act
    cache = kv_cache_bytes(cfg, shape) / mesh.n_chips
    act_dec = 10.0 * cfg.n_layers * (shape.global_batch / mesh.dp) * cfg.d_model * 2.0
    return w_shard + cache + act_dec


def model_collective_bytes(cfg: ArchConfig, shape: ShapeSpec,
                           mesh: MeshDesc) -> float:
    """Per-chip ICI traffic per step (napkin).

    Train: FSDP all-gathers (bf16 weights, 2 gathers: fwd-or-remat reuse +
    bwd) + gradient reduce-scatter (fp32/2 with int8 compression off) +
    TP all-reduces (2 per block on the residual stream).
    """
    n_mat = _matmul_params(cfg)
    tokens_dev = shape.global_batch * shape.seq_len / mesh.dp
    tp_ar = 2.0 * 2.0 * cfg.n_layers * tokens_dev * cfg.d_model * 2.0
    if shape.kind == "train":
        ag = 2.0 * 2.0 * n_mat / mesh.tp
        rs = 4.0 * n_mat / mesh.tp
        return ag + rs + tp_ar
    if shape.kind == "prefill":
        return 2.0 * n_mat / mesh.tp + tp_ar
    b_dev = shape.global_batch / mesh.dp
    tp_ar_dec = 2.0 * 2.0 * cfg.n_layers * b_dev * cfg.d_model * 2.0
    # sequence-sharded decode attention: logits/softmax partials ~ heads
    seq_ar = 4.0 * cfg.n_layers * b_dev * cfg.n_heads * 4.0
    return tp_ar_dec + seq_ar


@dataclasses.dataclass
class Roofline:
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)


# Effective links per collective: a v5e chip has 4 ICI links; a ring
# collective keeps ~2 busy (send+recv per axis).
EFFECTIVE_LINKS = 2.0


def analytic_roofline(cfg: ArchConfig, shape: ShapeSpec, mesh: MeshDesc,
                      hw: TPUSpec = TPU_V5E) -> Roofline:
    return Roofline(
        t_compute=model_flops(cfg, shape) / mesh.n_chips / hw.peak_flops,
        t_memory=model_hbm_bytes(cfg, shape, mesh) / hw.hbm_bw,
        t_collective=model_collective_bytes(cfg, shape, mesh)
        / (EFFECTIVE_LINKS * hw.ici_bw),
    )


def hlo_roofline(exact: dict, hw: TPUSpec = TPU_V5E) -> Roofline:
    """Roofline terms from the dry-run's parsed HLO (per-device numbers)."""
    return Roofline(
        t_compute=exact["flops"] / hw.peak_flops,
        t_memory=exact.get("mem_bytes", 0.0) / hw.hbm_bw,
        t_collective=exact["coll_total"] / (EFFECTIVE_LINKS * hw.ici_bw),
    )
