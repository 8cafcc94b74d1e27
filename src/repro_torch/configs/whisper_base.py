"""Whisper-base: 6L encoder + 6L decoder, conv frontend STUBBED
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
    vocab=51865, rope=False, gated_mlp=False, activation="gelu",
    norm="layernorm", tie_embeddings=True,
    n_enc_layers=6, n_audio_frames=1500, max_seq=32768,
)
