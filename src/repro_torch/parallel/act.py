"""Activation sharding specs, and the expert-parallel mesh they may name.

The counterpart of ``repro/parallel/act.py``. A spec is a tuple with one
entry per tensor dim: a mesh axis name, a tuple of names, or None
(PyTorch has no ``PartitionSpec``; ``sharding.placements`` turns a spec into
DTensor placements). The launcher installs a table for its mesh with
``use_activation_specs`` or the ``activation_specs`` context; with none
installed the models run unsharded.

``ep_mesh()`` is what the models read today: a table whose ``_ep_mesh`` key
holds ``(mesh, axis)`` sends ``moe.moe_mlp`` down its expert-parallel path
over that axis. ``constrain`` (pinning an activation to its spec) comes
with the sharded train step (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.parallel.collectives import axis_sizes

_STATE = threading.local()


def default_specs(mesh) -> dict[str, tuple]:
    """The reference's table for a mesh (a ``DeviceMesh`` or ``{axis: size}``)."""
    dp = ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
    dpa = dp if len(dp) > 1 else dp[0]
    return {
        # (B, S, D) residual-stream activations
        "act": (dpa, None, None),
        # (B, S, F) ffn hidden: TP-sharded (Megatron column output)
        "ffn": (dpa, None, "model"),
        # (B, S, 2*d_inner) mamba in_proj output
        "ffn2": (dpa, None, "model"),
        # (B, S, H*hd) attention output before the row-parallel wo
        "attn_out": (dpa, None, "model"),
        # (B, S, H, hd) attention heads: TP over heads
        "heads": (dpa, None, "model", None),
        # (B, S, V) logits: TP over vocab
        "logits": (dpa, None, "model"),
        # (E, C, D/F) MoE expert buffers: EP over experts
        "experts": ("model", None, None),
        # (E*C, D) flat expert buffers around the dispatch scatter/gather
        "experts_flat": ("model", None),
        # (k*T, D) flattened token stream entering/leaving dispatch
        "tokens_flat": (dpa, None),
        # (B, 1, D) decode activations
        "dec": (dpa, None, None),
    }


def use_activation_specs(specs: dict | None) -> None:
    """Install (or clear, with None) this thread's activation spec table."""
    _STATE.specs = specs


@contextlib.contextmanager
def activation_specs(specs: dict | None):
    prev = getattr(_STATE, "specs", None)
    _STATE.specs = specs
    try:
        yield
    finally:
        _STATE.specs = prev


def ep_mesh():
    """(mesh, axis) for expert parallelism, if the installed table names one
    (key ``_ep_mesh``); None otherwise."""
    specs = getattr(_STATE, "specs", None)
    if not specs:
        return None
    return specs.get("_ep_mesh")
