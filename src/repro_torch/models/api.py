"""Single entry point over the model zoo: init / loss / prefill / decode
dispatched on ``ArchConfig.family``.

The counterpart of ``repro/models/api.py``, family for family: the dense
and VLM LMs (``transformer``), MoE (``moe``, the dense dispatch on one
card), xLSTM (``recurrent``, family ``ssm``), the Zamba2 hybrid
(``recurrent``) and the Whisper encoder-decoder (``encdec``, family
``audio``, whose batches carry ``frames``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from . import encdec, moe, recurrent, transformer


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    kw = dict(generator=generator, device=device, dtype=dtype)
    if cfg.family == "moe":
        return moe.init_lm(cfg, **kw)
    if cfg.family == "ssm":
        return recurrent.init_xlstm(cfg, **kw)
    if cfg.family == "hybrid":
        return recurrent.init_zamba(cfg, **kw)
    if cfg.family == "audio":
        return encdec.init_encdec(cfg, **kw)
    return transformer.init_lm(cfg, **kw)  # dense | vlm


def loss_fn(params, cfg: ArchConfig, batch: dict, **kw) -> torch.Tensor:
    """batch: tokens/labels (+ patch_embeds for vlm, frames for audio) -> the
    mean cross entropy (plus the MoE's weighted aux loss).

    The forward runs with ``use_kernel=False``: the plain PyTorch products,
    norms and attention, which autograd differentiates. This is the
    reference's own training arithmetic (its train step reaches no Pallas
    kernel), not a fallback: the port's kernels have no backward, and their
    wrappers raise under autograd.
    """
    kw = dict(use_kernel=False, **kw)
    tokens, labels = batch["tokens"], batch["labels"]
    if cfg.family == "moe":
        return moe.loss_fn(params, cfg, tokens, labels, **kw)
    if cfg.family == "ssm":
        logits = recurrent.xlstm_forward(params, cfg, tokens, **kw)
    elif cfg.family == "hybrid":
        logits = recurrent.zamba_forward(params, cfg, tokens, **kw)
    elif cfg.family == "audio":
        return encdec.loss_fn(params, cfg, tokens, labels, batch["frames"], **kw)
    elif cfg.family == "vlm":
        return transformer.loss_fn(params, cfg, tokens, labels, batch["patch_embeds"], **kw)
    else:
        return transformer.loss_fn(params, cfg, tokens, labels, **kw)
    return transformer.softmax_xent(logits, labels)


def prefill_logits(params, cfg: ArchConfig, batch: dict, **kw):
    """Forward pass producing logits (the inference-prefill workload)."""
    tokens = batch["tokens"]
    if cfg.family == "moe":
        return moe.forward(params, cfg, tokens, **kw)[0]
    if cfg.family == "ssm":
        return recurrent.xlstm_forward(params, cfg, tokens, **kw)
    if cfg.family == "hybrid":
        return recurrent.zamba_forward(params, cfg, tokens, **kw)
    if cfg.family == "audio":
        return encdec.forward(params, cfg, tokens, batch["frames"], **kw)
    if cfg.family == "vlm":
        return transformer.forward(params, cfg, tokens, batch["patch_embeds"], **kw)
    return transformer.forward(params, cfg, tokens, **kw)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """The decode cache of ``batch`` sequences of at most ``s_max`` tokens.
    The audio family's cross K/V is zero until ``encdec.prefill_cross``
    fills it from the request's frames."""
    if cfg.family == "moe":
        return moe.init_cache(cfg, batch, s_max, dtype, device=device)
    if cfg.family == "ssm":
        return recurrent.xlstm_init_cache(cfg, batch, s_max, dtype, device=device)
    if cfg.family == "hybrid":
        return recurrent.zamba_init_cache(cfg, batch, s_max, dtype, device=device)
    if cfg.family == "audio":
        return encdec.init_cache(cfg, batch, s_max, cfg.n_audio_frames, dtype, device=device)
    return transformer.init_cache(cfg, batch, s_max, dtype, device=device)  # dense | vlm


def decode_step(params, cfg: ArchConfig, cache, tokens, pos, *, donate: bool = False, **kw):
    """(logits (B, vocab), new_cache): one new token per sequence.

    The cache passed in is not changed, unless ``donate=True`` (as
    ``jax.jit``'s ``donate_argnums``): then the dense and VLM families may
    update it in place and return it (``transformer.decode_step``); the
    other families take no notice. A caller that donates uses the returned
    cache, never the one it passed."""
    if cfg.family == "moe":
        return moe.decode_step(params, cfg, cache, tokens, pos, **kw)
    if cfg.family == "ssm":
        return recurrent.xlstm_decode_step(params, cfg, cache, tokens, pos, **kw)
    if cfg.family == "hybrid":
        return recurrent.zamba_decode_step(params, cfg, cache, tokens, pos, **kw)
    if cfg.family == "audio":
        return encdec.decode_step(params, cfg, cache, tokens, pos, **kw)
    return transformer.decode_step(params, cfg, cache, tokens, pos, donate=donate,
                                   **kw)  # dense | vlm
