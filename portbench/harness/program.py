"""The system under test, as the configuration file states it."""
from __future__ import annotations


def arch_config(config: dict):
    """The program's ``ArchConfig`` from the file's ``arch`` block."""
    from repro_torch.configs.base import ArchConfig, SSMCfg
    arch = dict(config["arch"])
    if arch.get("ssm") is not None:
        arch["ssm"] = SSMCfg(**arch["ssm"])
    return ArchConfig(**arch)
