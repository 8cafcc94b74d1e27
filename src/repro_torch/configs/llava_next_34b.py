"""LLaVA-NeXT-34B: Yi-34B text backbone + anyres vision tiling (frontend
STUBBED: input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-34b]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480,
    vocab=64000, activation="silu", gated_mlp=True, rope=True,
    n_patches=576, vision_embed_dim=1024,
)
