"""The run measures the PyTorch port alone: no JAX, and not the JAX package."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded() -> list[str]:
    """Modules in ``sys.modules`` whose top-level name (before the first dot),
    compared whole, is forbidden; ``repro_torch`` is not ``repro``."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def check(when: str) -> None:
    found = loaded()
    if found:
        raise SystemExit(f"portbench: refusing to measure: {', '.join(found[:20])} loaded {when}")
