"""Llama-4-Maverick 400B-A17B: MoE 128 experts top-1 + shared expert,
early-fusion multimodal (text path modeled). [hf:meta-llama/Llama-4]"""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, activation="silu", gated_mlp=True, rope=True,
    moe=MoECfg(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1),
)
