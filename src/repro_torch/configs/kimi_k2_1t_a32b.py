"""Kimi-K2 1T-A32B: trillion-param MoE, 384 experts top-8 + 1 shared,
d_ff_expert=2048. [arXiv:2501.kimi2]"""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_ff=2048,
    vocab=163840, activation="silu", gated_mlp=True, rope=True,
    moe=MoECfg(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1),
)
