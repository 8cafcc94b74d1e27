"""Dense decoder-only LM (starcoder2, h2o-danube, nemotron-4, the llava
backbone): prefill forward, training loss, and one-token decode against a
KV cache.

The counterpart of ``repro/models/transformer.py``. Weights are the same
nested dict as the JAX tree, with the blocks stacked along a leading
(L, ...) axis, so carrying weights across is a leaf-by-leaf conversion
(``params_from_jax``); the layers run in a Python loop over that axis
(``jax.lax.scan`` in the reference; its ``unroll`` is a JAX compile option
with no counterpart). ``remat`` is the reference's activation-checkpoint
policy per block: ``"full"`` recomputes the block in the backward pass
(``torch.utils.checkpoint``), ``"dots"`` saves the outputs of the products
without batch dimensions (the projections, as
``checkpoint_dots_with_no_batch_dims`` does) and recomputes the rest,
``"none"`` saves everything; it applies only while grad mode is on.

With ``use_kernel=True`` every dense product (wq, wk, wv, wo, w_up,
w_gate, w_down, the VLM projector and the LM head) goes through the matmul
kernel, every RMSNorm through the RMSNorm kernel, and prefill attention
through the flash-attention kernel. ``use_kernel=False`` takes their plain
versions: the oracle of tests and the smoke run, and the training route
(the kernels have no backward; ``api.loss_fn`` takes it).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve as _device
from repro_torch.kernels.decode_attention.ops import takes
from repro_torch.kernels.flash_attention.ops import attn_fn as flash_attn_fn
from repro_torch.tree import map_tree
from repro_torch.parallel.act import constrain, pinned, summed
from .layers import (dense_init, embed, embed_init, gqa_attention, gqa_decode_attention,
                     init_attention, init_mlp, init_rmsnorm, linear, mlp, rms_norm)


def _map(fn, tree):
    """``fn`` leaf by leaf over nested dicts: the walk of the stacked blocks
    on every forward and decode tick, kept to dicts so that it costs the
    host as little as possible (``tree.map_tree`` also takes lists)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees):
    """Trees of one structure stacked leaf by leaf along a new leading axis;
    one tree becomes views of its leaves (no copy of a large model's block)."""
    first = trees[0]
    if len(trees) == 1:
        return _map(lambda t: t.unsqueeze(0), first)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def layer(blocks, i: int):
    """The params of block ``i`` as views into the stacked (L, ...) leaves."""
    return _map(lambda t: t[i], blocks)


def unstack(blocks, n: int) -> list:
    """The params of each of the ``n`` blocks, as views into the stacked
    (n, ...) leaves: one ``unbind`` a leaf, whose backward stacks the
    blocks' gradients once (indexing block by block would add a zero
    gradient of the whole leaf per block)."""
    parts = _map(lambda t: t.unbind(0), blocks)
    return [_map(lambda p: p[i], parts) for i in range(n)]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of the 2-D
    products (the projections), recompute the rest (the attention's batched
    products included)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


REMATS = ("full", "dots", "none")


def rematted(fn, remat: str):
    """``fn`` under the activation-checkpoint policy ``remat`` while grad mode
    is on; ``fn`` itself otherwise."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}; got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                          _save_dots))


def init_block(generator: torch.Generator, cfg: ArchConfig, dtype=torch.float32, *,
               device="cpu"):
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device=device),
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                               dtype, device=device),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device=device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device=device),
    }


def init_lm(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
            dtype=torch.float32):
    """Random weights from ``generator``; the JAX initialisers' scales."""
    device = _device(device)
    params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype, device=device),
        "blocks": _stack([init_block(generator, cfg, dtype, device=device)
                          for _ in range(cfg.n_layers)]),
        "ln_f": init_rmsnorm(cfg.d_model, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab, dtype, device=device)
    if cfg.n_patches:
        params["projector"] = dense_init(generator, cfg.vision_embed_dim, cfg.d_model, dtype,
                                         device=device)
    return params


def params_from_jax(tree_np, *, device="cuda", dtype=None):
    """The JAX package's parameter tree (nested dicts and lists of numpy
    arrays) as tensors.

    ``dtype=None`` keeps each array's dtype; JAX's bfloat16 arrays become
    ``torch.bfloat16``.
    """
    device = _device(device)

    def leaf(a):
        a = np.array(a)  # a writable copy: JAX hands out read-only buffers
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through fp32
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    return map_tree(leaf, tree_np)


def _head(params) -> torch.Tensor:
    return params["lm_head"] if "lm_head" in params else params["embed"].t()


def block_apply(x, bp, cfg: ArchConfig, attn_fn=None, *, use_kernel: bool = False):
    x = x + gqa_attention(rms_norm(x, bp["ln1"], use_kernel=use_kernel), bp["attn"],
                          cfg.n_heads, cfg.n_kv, rope=cfg.rope, rope_theta=cfg.rope_theta,
                          window=cfg.window, attn_fn=attn_fn, use_kernel=use_kernel)
    x = x + mlp(rms_norm(x, bp["ln2"], use_kernel=use_kernel), bp["mlp"], cfg.activation,
                use_kernel=use_kernel)
    return x


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, patch_embeds=None, *,
            compute_dtype=torch.bfloat16, remat: str = "full",
            use_kernel: bool = True) -> torch.Tensor:
    """tokens (B, S_text) integer -> logits (B, S, vocab) in fp32.

    VLM: ``patch_embeds`` (B, P, vision_embed_dim) are projected and
    prepended to the token embeddings (the anyres frontend is a stub, as in
    the reference).
    """
    x = constrain(embed(params["embed"], tokens, compute_dtype), "act")
    if patch_embeds is not None:
        proj = linear(patch_embeds.to(compute_dtype), params["projector"], use_kernel)
        x = constrain(torch.cat([proj, x], dim=1), "act")
    attn_fn = flash_attn_fn if use_kernel else None
    body = rematted(block_apply, remat)
    for bp in unstack(params["blocks"], cfg.n_layers):
        x = constrain(body(x, bp, cfg, attn_fn, use_kernel=use_kernel), "act")
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    return constrain(linear(x, _head(params), use_kernel).float(), "logits")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy, contracting the vocab axis with a one-hot as the
    reference does. The one-hot is built by comparison, as
    ``jax.nn.one_hot`` is: a label outside [0, vocab) gives a zero row
    (its target logit counts as 0), where ``F.one_hot`` would raise.
    logsumexp in fp32, the target contraction in the logits' dtype, as a
    product and a sum over the vocab (one term is not zero, so any order of
    summing gives the reference's value; no batched product, which on a
    mesh would flatten the split batch and vocab dims together). On a mesh
    the per-token losses are summed over the vocab's split and their
    gradient pinned to their placements (``act.pinned``): DTensor would
    hand the mean's replicated gradient to the (B, S, V) products and cut
    it to the batch split one mesh dim at a time, a transient of the
    batch over the first dim alone (on 2x16x16, half the global batch's
    rows on every rank)."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    vocab = torch.arange(logits.shape[-1], device=labels.device)
    onehot = (labels[..., None] == vocab).to(logits.dtype)
    target = (logits * onehot).sum(-1).float()
    return pinned(summed(lse - target)).mean()


def loss_fn(params, cfg: ArchConfig, tokens, labels, patch_embeds=None, **kw) -> torch.Tensor:
    logits = forward(params, cfg, tokens, patch_embeds, **kw)
    if patch_embeds is not None:
        logits = logits[:, patch_embeds.shape[1]:]  # only text positions scored
    return softmax_xent(logits, labels)


# ---------------------------------------------------------------------------
# Decode (one new token against a KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """KV cache (L, B, S_max, n_kv, hd). Sliding-window archs only need the
    window slots (ring buffer)."""
    device = _device(device)
    slots = min(s_max, cfg.window) if cfg.window else s_max
    shape = (cfg.n_layers, batch, slots, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16, use_kernel: bool = True, donate: bool = False):
    """tokens (B, 1) integer; pos (B,) integer -> (logits (B, vocab), new cache).

    For windowed attention the cache slot is pos % window (ring buffer) and
    RoPE still uses the absolute position. The cache passed in is not
    changed, unless ``donate``.

    ``donate=True``, in the sense of ``jax.jit``'s ``donate_argnums``, lets
    the step update ``cache`` in place: with ``use_kernel`` on a cache that
    the decode-attention kernels take (``kernels.decode_attention.ops.takes``:
    plain contiguous tensors in ``compute_dtype``), each layer writes its new
    K/V into ``cache["k"]`` and ``cache["v"]`` and attends over each slot's
    valid positions only, and the step returns the same dict, with no stack
    of the layers' caches; otherwise it is the step above. A caller that
    donates uses the returned cache, never the one it passed.
    """
    x = constrain(embed(params["embed"], tokens, compute_dtype), "dec")
    slots = cache["k"].shape[2]
    in_place = donate and use_kernel and takes(cache["k"], cache["v"], compute_dtype,
                                               cfg.n_heads)
    if in_place:
        pos = pos.long()
    if cfg.window:
        write_pos = pos % slots                # ring buffer
        valid = torch.clamp(pos, max=slots - 1)  # full ring => all slots live
    else:
        write_pos, valid = pos, pos

    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        bp = layer(params["blocks"], i)
        h = rms_norm(x, bp["ln1"], use_kernel=use_kernel)
        out, k_c, v_c = gqa_decode_attention(
            h, bp["attn"], cfg.n_heads, cfg.n_kv, cache["k"][i], cache["v"][i], write_pos,
            rope_pos=pos, valid_upto=valid, rope=cfg.rope, rope_theta=cfg.rope_theta,
            use_kernel=use_kernel, donate=in_place)
        x = x + out
        x = x + mlp(rms_norm(x, bp["ln2"], use_kernel=use_kernel), bp["mlp"], cfg.activation,
                    use_kernel=use_kernel)
        x = constrain(x, "dec")
        k_new.append(k_c)
        v_new.append(v_c)
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    logits = linear(x[:, 0], _head(params), use_kernel).float()
    if in_place:
        return logits, cache
    return logits, {"k": torch.stack(k_new), "v": torch.stack(v_new)}
