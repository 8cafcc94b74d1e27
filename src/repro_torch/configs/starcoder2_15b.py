"""StarCoder2-15B: dense GQA + RoPE. [arXiv:2402.19173]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv=4, d_ff=24576,
    vocab=49152, activation="gelu", gated_mlp=False, rope=True,
)
