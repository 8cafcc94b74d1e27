"""Whisper-style encoder-decoder backbone (the audio family).

The counterpart of ``repro/models/encdec.py``. The conv frontend is a stub,
as in the reference: callers pass precomputed frame embeddings (B,
n_frames, d_model) and the encoder is the transformer stack on top of
them, with LayerNorm, the tanh GELU MLP and Whisper's sinusoidal
positions; the decoder has learned positions, causal self-attention,
cross-attention to the encoder's output and the tied head ``embed.T``.
The blocks are stacked along a leading (L, ...) axis as in the JAX tree,
so ``transformer.params_from_jax`` carries them across.

With ``use_kernel=True`` every dense product goes through the matmul
kernel and the prefill's attentions through the flash-attention kernel:
the encoder's (not causal, S = Sk = frames), the decoder's causal
self-attention and its cross-attention (not causal, the decoder's S
queries over the frames' keys). The reference's ``forward`` hands no
``attn_fn`` to ``encode`` and its cross-attention never takes one; the
port routes every prefill attention by ``use_kernel``, and the tests hold
the kernel route to the plain one, the plain one to the reference.
LayerNorm has no kernel (the reference has none) and runs plain; decode's
attentions over the caches stay plain, as in the LMs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import attn_fn as flash_attn_fn
from repro_torch.parallel.act import constrain
from .layers import (_randn, embed, embed_init, gqa_attention, gqa_decode_attention, init_attention,
                     init_layernorm, init_mlp, layer_norm, linear, mlp, split_last)
from .transformer import _device, _stack, layer, rematted, softmax_xent, unstack


def sinusoids(length: int, channels: int, *, device="cpu") -> torch.Tensor:
    """Whisper's sinusoidal position embedding (length, channels) in fp32."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32,
                                                  device=device))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _init_enc_block(generator, cfg: ArchConfig, dtype, device):
    return {
        "ln1": init_layernorm(cfg.d_model, dtype, device=device),
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                               dtype, device=device),
        "ln2": init_layernorm(cfg.d_model, dtype, device=device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, False, dtype, device=device),
    }


def _init_dec_block(generator, cfg: ArchConfig, dtype, device):
    return {
        "ln1": init_layernorm(cfg.d_model, dtype, device=device),
        "self_attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                    cfg.head_dim, dtype, device=device),
        "ln_x": init_layernorm(cfg.d_model, dtype, device=device),
        "cross_attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                     cfg.head_dim, dtype, device=device),
        "ln2": init_layernorm(cfg.d_model, dtype, device=device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, False, dtype, device=device),
    }


def init_encdec(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    """Random weights from ``generator`` at the JAX initialisers' scales."""
    device = _device(device)
    return {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype, device=device),
        "pos_dec": (_randn(generator, (cfg.max_seq, cfg.d_model), device) * 0.01).to(dtype),
        "enc_blocks": _stack([_init_enc_block(generator, cfg, dtype, device)
                              for _ in range(cfg.n_enc_layers)]),
        "dec_blocks": _stack([_init_dec_block(generator, cfg, dtype, device)
                              for _ in range(cfg.n_layers)]),
        "ln_enc": init_layernorm(cfg.d_model, dtype, device=device),
        "ln_f": init_layernorm(cfg.d_model, dtype, device=device),
    }


def enc_block(x, bp, cfg: ArchConfig, *, use_kernel: bool = False):
    """One encoder block: bidirectional self-attention and the GELU MLP."""
    attn_fn = flash_attn_fn if use_kernel else None
    x = x + gqa_attention(layer_norm(x, bp["ln1"]), bp["attn"], cfg.n_heads, cfg.n_kv,
                          rope=False, causal=False, attn_fn=attn_fn, use_kernel=use_kernel)
    x = x + mlp(layer_norm(x, bp["ln2"]), bp["mlp"], "gelu", use_kernel=use_kernel)
    return constrain(x, "act")


def encode(params, cfg: ArchConfig, frames: torch.Tensor, *, compute_dtype=torch.bfloat16,
           use_kernel: bool = True) -> torch.Tensor:
    """frames (B, F, d_model), the stubbed frontend's output -> memory (B, F,
    d_model) in the compute dtype."""
    x = frames.to(compute_dtype)
    x = x + sinusoids(x.shape[1], cfg.d_model, device=x.device).to(compute_dtype)[None]
    for bp in unstack(params["enc_blocks"], cfg.n_enc_layers):
        x = enc_block(x, bp, cfg, use_kernel=use_kernel)
    return layer_norm(x, params["ln_enc"])


def _cross_kv(memory, p, cfg: ArchConfig, use_kernel: bool):
    """The cross-attention's K and V (B, F, n_kv, hd) from the encoder's output."""
    mk = split_last(linear(memory, p["wk"], use_kernel), cfg.n_kv, cfg.head_dim)
    mv = split_last(linear(memory, p["wv"], use_kernel), cfg.n_kv, cfg.head_dim)
    return mk, mv


def dec_block(x, bp, memory, cfg: ArchConfig, *, use_kernel: bool = False):
    """One decoder block of the teacher-forced decoder: causal self-attention,
    cross-attention to ``memory``, the GELU MLP."""
    attn_fn = flash_attn_fn if use_kernel else None
    x = x + gqa_attention(layer_norm(x, bp["ln1"]), bp["self_attn"], cfg.n_heads, cfg.n_kv,
                          rope=False, causal=True, attn_fn=attn_fn, use_kernel=use_kernel)
    h = layer_norm(x, bp["ln_x"])
    kv = _cross_kv(memory, bp["cross_attn"], cfg, use_kernel)
    x = x + gqa_attention(h, bp["cross_attn"], cfg.n_heads, cfg.n_kv, rope=False, causal=False,
                          kv_override=kv, attn_fn=attn_fn, use_kernel=use_kernel)
    x = x + mlp(layer_norm(x, bp["ln2"]), bp["mlp"], "gelu", use_kernel=use_kernel)
    return constrain(x, "act")


def decode_train(params, cfg: ArchConfig, tokens: torch.Tensor, memory: torch.Tensor, *,
                 compute_dtype=torch.bfloat16, remat: str = "full",
                 use_kernel: bool = True) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S) integer -> logits (B, S, vocab)
    in fp32. ``remat="full"`` checkpoints each block while grad mode is on,
    as the reference does; any other value runs them plainly."""
    s = tokens.shape[1]
    x = embed(params["embed"], tokens, compute_dtype)
    x = x + params["pos_dec"][:s].to(compute_dtype)[None]
    body = rematted(dec_block, "full") if remat == "full" else dec_block
    for bp in unstack(params["dec_blocks"], cfg.n_layers):
        x = body(x, bp, memory, cfg, use_kernel=use_kernel)
    x = layer_norm(x, params["ln_f"])
    return constrain(linear(x, params["embed"].t(), use_kernel).float(), "logits")


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, frames: torch.Tensor, *,
            compute_dtype=torch.bfloat16, remat: str = "full",
            use_kernel: bool = True) -> torch.Tensor:
    memory = encode(params, cfg, frames, compute_dtype=compute_dtype, use_kernel=use_kernel)
    return decode_train(params, cfg, tokens, memory, compute_dtype=compute_dtype, remat=remat,
                        use_kernel=use_kernel)


def loss_fn(params, cfg: ArchConfig, tokens, labels, frames, **kw) -> torch.Tensor:
    return softmax_xent(forward(params, cfg, tokens, frames, **kw), labels)


# ---------------------------------------------------------------------------
# Decode (one new token against the self KV cache and the cross K/V)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, s_max: int, n_frames: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """The self-attention KV cache (L, B, S_max, n_kv, hd) and the
    cross-attention K/V (L, B, n_frames, n_kv, hd), which ``prefill_cross``
    fills once per request from the encoder's output."""
    device = _device(device)
    kv = (cfg.n_layers, batch, s_max, cfg.n_kv, cfg.head_dim)
    xkv = (cfg.n_layers, batch, n_frames, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "xk": torch.zeros(xkv, dtype=dtype, device=device),
            "xv": torch.zeros(xkv, dtype=dtype, device=device)}


def prefill_cross(params, cfg: ArchConfig, memory: torch.Tensor, cache, *,
                  use_kernel: bool = True):
    """The cache with its cross K/V computed from ``memory`` (B, F, d_model)
    in memory's dtype, stored in the cache's; the cache passed in is not
    changed."""
    kvs = [_cross_kv(memory, bp["cross_attn"], cfg, use_kernel)
           for bp in unstack(params["dec_blocks"], cfg.n_layers)]
    return {**cache, "xk": torch.stack([k for k, _ in kvs]).to(cache["xk"].dtype),
            "xv": torch.stack([v for _, v in kvs]).to(cache["xv"].dtype)}


def decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16, use_kernel: bool = True):
    """tokens (B, 1) integer; pos (B,) integer -> (logits (B, vocab), new
    cache). The cache passed in is not changed."""
    x = embed(params["embed"], tokens, compute_dtype)
    x = x + embed(params["pos_dec"], pos, compute_dtype)[:, None]
    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        bp = layer(params["dec_blocks"], i)
        out, k_c, v_c = gqa_decode_attention(
            layer_norm(x, bp["ln1"]), bp["self_attn"], cfg.n_heads, cfg.n_kv, cache["k"][i],
            cache["v"][i], pos, rope=False, use_kernel=use_kernel)
        x = x + out
        x = x + gqa_attention(layer_norm(x, bp["ln_x"]), bp["cross_attn"], cfg.n_heads,
                              cfg.n_kv, rope=False, causal=False,
                              kv_override=(cache["xk"][i], cache["xv"][i]),
                              use_kernel=use_kernel)
        x = x + mlp(layer_norm(x, bp["ln2"]), bp["mlp"], "gelu", use_kernel=use_kernel)
        k_new.append(k_c)
        v_new.append(v_c)
    x = layer_norm(x, params["ln_f"])
    logits = linear(x[:, 0], params["embed"].t(), use_kernel).float()
    return logits, {**cache, "k": torch.stack(k_new), "v": torch.stack(v_new)}
