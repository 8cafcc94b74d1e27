"""Architecture + workload-shape configuration system.

Every assigned architecture is an :class:`ArchConfig` in its own module
under ``repro/configs``; ``repro.configs.get_config(name)`` resolves it.
Workload shapes (the 4 assigned input-shape cells) are :class:`ShapeSpec`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 1          # shared-expert(s) run for every token
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 64        # N (per-head state size)
    head_dim: int = 64
    expansion: int = 2
    conv_width: int = 4
    chunk: int = 256           # SSD chunk length
    # xlstm: 1 sLSTM block per `slstm_every` mLSTM blocks (0 = none)
    slstm_every: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    # family extras
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    window: int | None = None           # sliding-window attention
    rope: bool = True
    rope_theta: float = 10000.0
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    # hybrid (zamba2): one shared attention block applied every N layers
    shared_attn_every: int = 0
    # vlm: number of (precomputed, stubbed) vision patch embeddings per sample
    n_patches: int = 0
    vision_embed_dim: int = 0
    # audio (whisper): encoder config; decoder uses the top-level fields
    n_enc_layers: int = 0
    n_audio_frames: int = 0             # precomputed frame embeddings (stub)
    # attention is sub-quadratic (SSM state or bounded window) => long-context OK
    max_seq: int = 131072

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv * hd) * 2
        mlp = d * f * (3 if self.gated_mlp else 2)
        if self.moe:
            e = self.moe
            expert = d * e.d_ff_expert * 3
            mlp = e.n_experts * expert + e.n_shared * expert + d * e.n_experts
        per_layer = attn + mlp
        if self.family in ("ssm", "hybrid"):
            s = self.ssm or SSMCfg()
            d_in = s.expansion * d
            per_layer = d * (2 * d_in) + d_in * d  # in/out projections
            n_h = d_in // s.head_dim
            per_layer += d * (2 * n_h * s.state_dim) + d * n_h  # B,C,dt projs
            if self.family == "hybrid":
                pass  # shared attn counted once below
        total = self.n_layers * per_layer
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.shared_attn_every:
            total += attn + d * f * (3 if self.gated_mlp else 2)
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + mlp) + self.n_layers * attn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        e = self.moe
        expert = d * e.d_ff_expert * 3
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv * hd) * 2
        per_layer = attn + (e.top_k + e.n_shared) * expert + d * e.n_experts
        return self.n_layers * per_layer + self.vocab * d * 2

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 2 if not self.shared_attn_every
                         else max(2, min(4, self.shared_attn_every))),
            d_model=128,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            max_seq=512,
        )
        if self.moe:
            changes["moe"] = MoECfg(n_experts=4, top_k=min(self.moe.top_k, 2),
                                    d_ff_expert=64, n_shared=self.moe.n_shared)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=32, chunk=32,
                slstm_every=2 if self.ssm.slstm_every else 0)
        if self.window:
            changes["window"] = 64
        if self.shared_attn_every:
            changes["shared_attn_every"] = 2
        if self.n_patches:
            changes["n_patches"] = 16
            changes["vision_embed_dim"] = 128
        if self.n_enc_layers:
            changes["n_enc_layers"] = 2
            changes["n_audio_frames"] = 64
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int

    def reduced(self) -> "ShapeSpec":
        return dataclasses.replace(self, seq_len=min(self.seq_len, 64),
                                   global_batch=min(self.global_batch, 2))


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
