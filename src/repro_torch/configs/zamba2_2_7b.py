"""Zamba2-2.7B: Mamba2 backbone + ONE shared attention block reused every
6 layers (MHA kv=32), ssm_state=64. [arXiv:2411.15242]"""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240,
    vocab=32000, activation="silu", gated_mlp=True, rope=True,
    ssm=SSMCfg(state_dim=64, head_dim=64, expansion=2, chunk=256),
    shared_attn_every=6, max_seq=524288,
)
