"""Config registry of the port: ``get_config("<arch-id>")`` -> ArchConfig.

``base.py`` and the config modules are verbatim copies of ``repro/configs``,
one for every architecture of the JAX package; ``all_configs`` and
``cell_enabled`` are the reference registry's own.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, MoECfg, ShapeSpec, SSMCfg

ARCH_IDS = (
    "nemotron-4-340b",
    "starcoder2-3b",
    "starcoder2-15b",
    "h2o-danube-3-4b",
    "xlstm-350m",
    "llava-next-34b",
    "llama4-maverick-400b-a17b",
    "kimi-k2-1t-a32b",
    "zamba2-2.7b",
    "whisper-base",
)


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# Which (arch x shape) cells run. long_500k needs sub-quadratic attention:
# run for SSM/hybrid/SWA archs, skip for pure full-attention ones (noted in
# DESIGN.md SS Arch-applicability).
def cell_enabled(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full attention is quadratic at 500k; skipped per spec"
    return True, ""


__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "MoECfg", "SSMCfg", "ShapeSpec",
           "get_config", "all_configs", "cell_enabled"]
