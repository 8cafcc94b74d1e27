"""Single entry point over the model zoo: init / prefill / decode dispatched
on ``ArchConfig.family``.

The counterpart of ``repro/models/api.py``. Only the dense family is
ported; every other family raises ``NotImplementedError`` naming the
ROADMAP.md queue 1 item that ports it. ``loss_fn`` waits for the training
slice (item 5).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from . import transformer

_NOT_PORTED = {
    "moe": "item 9 (MoE)",
    "ssm": "item 8 (SSM and hybrid families)",
    "hybrid": "item 8 (SSM and hybrid families)",
    "audio": "item 10 (encoder-decoder)",
    "vlm": "item 4 (the VLM branch of the dense LM)",
}


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
                                  f"ROADMAP.md queue 1 {_NOT_PORTED.get(cfg.family, '')}")


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    _dense_only(cfg)
    return transformer.init_lm(cfg, generator=generator, device=device, dtype=dtype)


def prefill_logits(params, cfg: ArchConfig, batch: dict, **kw):
    """Forward pass producing logits (the inference-prefill workload)."""
    _dense_only(cfg)
    return transformer.forward(params, cfg, batch["tokens"], **kw)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
               device="cuda"):
    _dense_only(cfg)
    return transformer.init_cache(cfg, batch, s_max, dtype, device=device)


def decode_step(params, cfg: ArchConfig, cache, tokens, pos, **kw):
    """(logits (B, vocab), new_cache): one new token per sequence."""
    _dense_only(cfg)
    return transformer.decode_step(params, cfg, cache, tokens, pos, **kw)
