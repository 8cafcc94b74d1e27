"""H2O-Danube-3-4B: llama+mistral mix with sliding-window attention.
SWA makes long_500k decode sub-quadratic (bounded KV ring buffer).
[arXiv:2401.16818]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv=8, d_ff=10240,
    vocab=32000, activation="silu", gated_mlp=True, rope=True,
    window=4096, max_seq=524288,
)
