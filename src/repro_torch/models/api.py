"""Single entry point over the model zoo: init / prefill / decode dispatched
on ``ArchConfig.family``.

The counterpart of ``repro/models/api.py``. The dense and hybrid (Zamba2)
families are ported; every other family raises ``NotImplementedError``
naming the ROADMAP.md queue 1 item that ports it. ``loss_fn`` waits for the
training slice (item 5).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from . import recurrent, transformer

_NOT_PORTED = {
    "moe": "item 9 (MoE)",
    "ssm": "item 8 (the xLSTM part of the SSM family)",
    "audio": "item 10 (encoder-decoder)",
    "vlm": "item 4 (the VLM branch of the dense LM)",
}


def _ported(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
                                  f"ROADMAP.md queue 1 {_NOT_PORTED.get(cfg.family, '')}")


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    _ported(cfg)
    if cfg.family == "hybrid":
        return recurrent.init_zamba(cfg, generator=generator, device=device, dtype=dtype)
    return transformer.init_lm(cfg, generator=generator, device=device, dtype=dtype)


def prefill_logits(params, cfg: ArchConfig, batch: dict, **kw):
    """Forward pass producing logits (the inference-prefill workload)."""
    _ported(cfg)
    if cfg.family == "hybrid":
        return recurrent.zamba_forward(params, cfg, batch["tokens"], **kw)
    return transformer.forward(params, cfg, batch["tokens"], **kw)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
               device="cuda"):
    _ported(cfg)
    if cfg.family == "hybrid":
        return recurrent.zamba_init_cache(cfg, batch, s_max, dtype, device=device)
    return transformer.init_cache(cfg, batch, s_max, dtype, device=device)


def decode_step(params, cfg: ArchConfig, cache, tokens, pos, **kw):
    """(logits (B, vocab), new_cache): one new token per sequence."""
    _ported(cfg)
    if cfg.family == "hybrid":
        return recurrent.zamba_decode_step(params, cfg, cache, tokens, pos, **kw)
    return transformer.decode_step(params, cfg, cache, tokens, pos, **kw)
