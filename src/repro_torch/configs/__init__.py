"""Config registry of the port: ``get_config("<arch-id>")`` -> ArchConfig.

``base.py`` and the config modules are copies of ``repro/configs``; only the
architectures whose model path is ported are here. Asking for another one
raises ``KeyError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, MoECfg, ShapeSpec, SSMCfg

ARCH_IDS = (
    "nemotron-4-340b",
    "starcoder2-3b",
    "starcoder2-15b",
    "h2o-danube-3-4b",
    "llava-next-34b",
    "zamba2-2.7b",
)

# Architectures of the JAX package that the port does not serve yet, with
# the ROADMAP.md queue 1 item that ports them.
NOT_PORTED = {
    "xlstm-350m": "item 8 (the xLSTM part of the SSM family)",
    "llama4-maverick-400b-a17b": "item 9 (MoE)",
    "kimi-k2-1t-a32b": "item 9 (MoE)",
    "whisper-base": "item 10 (encoder-decoder)",
}


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet: ROADMAP.md queue 1 "
                       f"{NOT_PORTED[arch_id]}")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "MoECfg", "SSMCfg", "ShapeSpec",
           "get_config"]
