"""Recurrent-family LMs: xLSTM (sLSTM + mLSTM blocks) and Zamba2 (Mamba2
backbone + one *shared* attention block reused every N layers).

The counterpart of ``repro/models/recurrent.py``. xLSTM's blocks are
heterogeneous, so its weights and its decode cache are Python lists with
one dict per block (``kind_mlstm`` or ``kind_slstm`` plus the pre-norm
``ln``), as in the JAX tree. Zamba2's weights are the JAX tree: the
Mamba2 leaves stacked along (G, per, ...) (G groups of
``cfg.shared_attn_every`` layers), the shared attention and MLP block
stored once, one shared pre-norm scale ``mamba_ln``; so
``transformer.params_from_jax`` carries them across unchanged. Python loops
replace ``jax.lax.scan`` (its ``unroll`` is a JAX compile option with no
counterpart). ``remat="full"`` checkpoints each group (its Mamba2 layers
and the shared block) while grad mode is on, as the reference's
``jax.checkpoint(group)`` does; any other value runs the groups plainly,
as there.

With ``use_kernel=True`` the prefill scan goes through the SSD kernel,
prefill attention through the flash-attention kernel, every dense product
through the matmul kernel and every RMSNorm through the RMSNorm kernel;
decode runs the plain ``ssd_decode`` and the plain attention over the
cache, as the reference does. The xLSTM blocks take the matmul kernel for
every product and the RMSNorm kernel for every norm; their gating and
scans are plain PyTorch, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import attn_fn as flash_attn_fn
from repro_torch.parallel.act import constrain
from .layers import (dense_init, embed, embed_init, gqa_attention, gqa_decode_attention,
                     init_attention, init_mlp, init_rmsnorm, linear, mlp, rms_norm)
from .ssm import (init_mamba2, init_mlstm, init_slstm, mamba2_apply, mamba2_decode,
                  mlstm_apply, mlstm_decode, slstm_apply)
from .transformer import _device, _stack, layer, map_tree, rematted, unstack

# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------


def _is_slstm(cfg: ArchConfig, i: int) -> bool:
    ev = cfg.ssm.slstm_every
    return bool(ev) and (i % ev == ev - 1)


def init_xlstm(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
               dtype=torch.float32):
    """Random weights from ``generator`` at the JAX initialisers' scales."""
    device = _device(device)
    params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype, device=device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab, dtype, device=device),
    }
    blocks = []
    for i in range(cfg.n_layers):
        if _is_slstm(cfg, i):
            cell = {"kind_slstm": init_slstm(generator, cfg.d_model, cfg.n_heads, dtype,
                                             device=device)}
        else:
            cell = {"kind_mlstm": init_mlstm(generator, cfg.d_model, cfg.n_heads, dtype,
                                             device=device)}
        blocks.append({**cell, "ln": init_rmsnorm(cfg.d_model, dtype, device=device)})
    params["blocks"] = blocks  # heterogeneous: a list, not stacked
    params["ln_f"] = init_rmsnorm(cfg.d_model, dtype, device=device)
    return params


def xlstm_block(x, bp, cfg: ArchConfig, *, use_kernel: bool = False):
    """One pre-norm residual xLSTM block of the prefill forward."""
    h = rms_norm(x, bp["ln"], use_kernel=use_kernel)
    if "kind_mlstm" in bp:
        chunk = cfg.ssm.chunk if cfg.ssm else 256
        return x + mlstm_apply(h, bp["kind_mlstm"], cfg.n_heads, chunk, use_kernel=use_kernel)
    return x + slstm_apply(h, bp["kind_slstm"], use_kernel=use_kernel)[0]


def xlstm_forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
                  compute_dtype=torch.bfloat16, remat: str = "full",
                  use_kernel: bool = True) -> torch.Tensor:
    """tokens (B, S) integer -> logits (B, S, vocab) in fp32. ``remat="full"``
    checkpoints each block while grad mode is on, as the reference's
    ``jax.checkpoint(body)`` does; any other value runs them plainly."""
    x = constrain(embed(params["embed"], tokens, compute_dtype), "act")
    body = rematted(xlstm_block, "full") if remat == "full" else xlstm_block
    for bp in params["blocks"]:
        x = constrain(body(x, bp, cfg, use_kernel=use_kernel), "act")
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    return constrain(linear(x, params["lm_head"], use_kernel).float(), "logits")


def xlstm_init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
                     device="cuda"):
    """One dict of recurrent state per block: the sLSTM's h (in ``dtype``)
    and c; the mLSTM's C, n and its stabiliser m at its initial -1e30."""
    device = _device(device)
    hd = cfg.d_model // cfg.n_heads
    f32 = torch.float32
    caches = []
    for i in range(cfg.n_layers):
        if _is_slstm(cfg, i):
            caches.append({"h": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
                           "c": torch.zeros((batch, cfg.d_model), dtype=f32, device=device)})
        else:
            caches.append({
                "c": torch.zeros((batch, cfg.n_heads, hd, hd), dtype=f32, device=device),
                "n": torch.zeros((batch, cfg.n_heads, hd), dtype=f32, device=device),
                "m": torch.full((batch, cfg.n_heads), -1e30, dtype=f32, device=device)})
    return caches


def xlstm_decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos: torch.Tensor,
                      *, compute_dtype=torch.bfloat16, use_kernel: bool = True):
    """tokens (B, 1) integer -> (logits (B, vocab), new cache). ``pos`` is
    unused: the state is not positional. The cache passed in is not changed."""
    x = embed(params["embed"], tokens, compute_dtype)
    new_cache = []
    for bp, cc in zip(params["blocks"], cache):
        h = rms_norm(x, bp["ln"], use_kernel=use_kernel)
        if "kind_mlstm" in bp:
            y, c, n, m = mlstm_decode(h, bp["kind_mlstm"], cfg.n_heads, cc["c"], cc["n"],
                                      cc["m"], use_kernel=use_kernel)
            new_cache.append({"c": c, "n": n, "m": m})
        else:
            y, hs, c = slstm_apply(h, bp["kind_slstm"], cc["h"], cc["c"], use_kernel=use_kernel)
            new_cache.append({"h": hs, "c": c})
        x = x + y
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    return linear(x[:, 0], params["lm_head"], use_kernel).float(), new_cache


# ---------------------------------------------------------------------------
# Zamba2 (hybrid)
# ---------------------------------------------------------------------------


def init_zamba(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
               dtype=torch.float32):
    """cfg.shared_attn_every Mamba2 layers per group; ONE shared attention
    (+MLP) block reused after each group. Random weights from ``generator``
    at the JAX initialisers' scales."""
    device = _device(device)
    per = cfg.shared_attn_every
    n_groups = cfg.n_layers // per
    params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype, device=device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab, dtype, device=device),
    }
    stacked = _stack([init_mamba2(generator, cfg.d_model, cfg.ssm, dtype, device=device)
                      for _ in range(cfg.n_layers)])
    params["mamba"] = map_tree(lambda t: t.reshape(n_groups, per, *t.shape[1:]), stacked)
    params["shared"] = {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device=device),
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                               dtype, device=device),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device=device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device=device),
    }
    params["mamba_ln"] = init_rmsnorm(cfg.d_model, dtype, device=device)
    params["ln_f"] = init_rmsnorm(cfg.d_model, dtype, device=device)
    return params


def _groups(cfg: ArchConfig) -> tuple[int, int]:
    return cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every


def zamba_forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
                  compute_dtype=torch.bfloat16, remat: str = "full",
                  use_kernel: bool = True) -> torch.Tensor:
    """tokens (B, S) integer -> logits (B, S, vocab) in fp32."""
    x = constrain(embed(params["embed"], tokens, compute_dtype), "act")
    shared = params["shared"]
    attn_fn = flash_attn_fn if use_kernel else None
    n_groups, per = _groups(cfg)

    def group(x, gp):
        for mp in unstack(gp, per):
            h = rms_norm(x, params["mamba_ln"], use_kernel=use_kernel)
            x = x + mamba2_apply(h, mp, cfg.ssm, use_kernel=use_kernel)
        # the shared attention block (the same params after every group)
        x = x + gqa_attention(rms_norm(x, shared["ln1"], use_kernel=use_kernel),
                              shared["attn"], cfg.n_heads, cfg.n_kv, rope=cfg.rope,
                              rope_theta=cfg.rope_theta, attn_fn=attn_fn, use_kernel=use_kernel)
        x = x + mlp(rms_norm(x, shared["ln2"], use_kernel=use_kernel), shared["mlp"],
                    cfg.activation, use_kernel=use_kernel)
        return constrain(x, "act")

    body = rematted(group, "full") if remat == "full" else group
    for gp in unstack(params["mamba"], n_groups):
        x = body(x, gp)
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    return constrain(linear(x, params["lm_head"], use_kernel).float(), "logits")


def zamba_init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
                     device="cuda"):
    """Conv and SSM states per Mamba2 layer, and one KV cache per group (the
    shared block runs once per group)."""
    device = _device(device)
    s = cfg.ssm
    d_in = s.expansion * cfg.d_model
    n_h = d_in // s.head_dim
    n_groups, per = _groups(cfg)
    kv = (n_groups, batch, s_max, cfg.n_kv, cfg.head_dim)
    return {
        "conv": torch.zeros((n_groups, per, batch, s.conv_width - 1, d_in), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((n_groups, per, batch, n_h, s.head_dim, s.state_dim),
                           dtype=torch.float32, device=device),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
    }


def zamba_decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos: torch.Tensor,
                      *, compute_dtype=torch.bfloat16, use_kernel: bool = True):
    """tokens (B, 1) integer; pos (B,) integer -> (logits (B, vocab), new cache).

    The cache passed in is not changed.
    """
    x = embed(params["embed"], tokens, compute_dtype)
    shared = params["shared"]
    n_groups, per = _groups(cfg)
    conv_n, ssm_n, k_n, v_n = [], [], [], []
    for g in range(n_groups):
        gp = layer(params["mamba"], g)
        for i in range(per):
            y, cc, sc = mamba2_decode(rms_norm(x, params["mamba_ln"], use_kernel=use_kernel),
                                      layer(gp, i), cfg.ssm, cache["conv"][g, i],
                                      cache["ssm"][g, i], use_kernel=use_kernel)
            x = x + y
            conv_n.append(cc)
            ssm_n.append(sc)
        out, k_c, v_c = gqa_decode_attention(
            rms_norm(x, shared["ln1"], use_kernel=use_kernel), shared["attn"], cfg.n_heads,
            cfg.n_kv, cache["k"][g], cache["v"][g], pos, rope=cfg.rope,
            rope_theta=cfg.rope_theta, use_kernel=use_kernel)
        x = x + out
        x = x + mlp(rms_norm(x, shared["ln2"], use_kernel=use_kernel), shared["mlp"],
                    cfg.activation, use_kernel=use_kernel)
        k_n.append(k_c)
        v_n.append(v_c)
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    logits = linear(x[:, 0], params["lm_head"], use_kernel).float()

    def grouped(ts):
        t = torch.stack(ts)
        return t.reshape(n_groups, per, *t.shape[1:])

    return logits, {"conv": grouped(conv_n), "ssm": grouped(ssm_n),
                    "k": torch.stack(k_n), "v": torch.stack(v_n)}
