"""Single entry point over the model zoo: init / loss / prefill / decode
dispatched on ``ArchConfig.family``.

The counterpart of ``repro/models/api.py``. The dense, VLM (the dense LM
with a projector for precomputed patch embeddings) and hybrid (Zamba2)
families are ported; every other family raises ``NotImplementedError``
naming the ROADMAP.md queue 1 item that ports it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from . import recurrent, transformer

_NOT_PORTED = {
    "moe": "item 9 (MoE)",
    "ssm": "item 8 (the xLSTM part of the SSM family)",
    "audio": "item 10 (encoder-decoder)",
}


def _ported(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "vlm", "hybrid"):
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
                                  f"ROADMAP.md queue 1 {_NOT_PORTED.get(cfg.family, '')}")


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    _ported(cfg)
    if cfg.family == "hybrid":
        return recurrent.init_zamba(cfg, generator=generator, device=device, dtype=dtype)
    return transformer.init_lm(cfg, generator=generator, device=device, dtype=dtype)  # dense | vlm


def loss_fn(params, cfg: ArchConfig, batch: dict, **kw) -> torch.Tensor:
    """batch: tokens/labels (+ patch_embeds for vlm) -> the mean cross entropy.

    The forward runs with ``use_kernel=False``: the plain PyTorch products,
    norms and attention, which autograd differentiates. This is the
    reference's own training arithmetic (its train step reaches no Pallas
    kernel), not a fallback: the port's kernels have no backward, and their
    wrappers raise under autograd.
    """
    _ported(cfg)
    if cfg.family == "hybrid":
        logits = recurrent.zamba_forward(params, cfg, batch["tokens"], use_kernel=False, **kw)
        return transformer.softmax_xent(logits, batch["labels"])
    if cfg.family == "vlm":
        return transformer.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                                   batch["patch_embeds"], use_kernel=False, **kw)
    return transformer.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                               use_kernel=False, **kw)


def prefill_logits(params, cfg: ArchConfig, batch: dict, **kw):
    """Forward pass producing logits (the inference-prefill workload)."""
    _ported(cfg)
    if cfg.family == "hybrid":
        return recurrent.zamba_forward(params, cfg, batch["tokens"], **kw)
    if cfg.family == "vlm":
        return transformer.forward(params, cfg, batch["tokens"], batch["patch_embeds"], **kw)
    return transformer.forward(params, cfg, batch["tokens"], **kw)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
               device="cuda"):
    _ported(cfg)
    if cfg.family == "hybrid":
        return recurrent.zamba_init_cache(cfg, batch, s_max, dtype, device=device)
    return transformer.init_cache(cfg, batch, s_max, dtype, device=device)  # dense | vlm


def decode_step(params, cfg: ArchConfig, cache, tokens, pos, **kw):
    """(logits (B, vocab), new_cache): one new token per sequence."""
    _ported(cfg)
    if cfg.family == "hybrid":
        return recurrent.zamba_decode_step(params, cfg, cache, tokens, pos, **kw)
    return transformer.decode_step(params, cfg, cache, tokens, pos, **kw)  # dense | vlm
