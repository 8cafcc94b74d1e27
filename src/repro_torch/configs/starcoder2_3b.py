"""StarCoder2-3B: dense GQA + RoPE. [arXiv:2402.19173]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_ff=12288,
    vocab=49152, activation="gelu", gated_mlp=False, rope=True,
)
