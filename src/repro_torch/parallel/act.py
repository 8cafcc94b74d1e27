"""Activation sharding specs, the constraints that pin activations to
them, and the expert-parallel mesh a table may name.

The counterpart of ``repro/parallel/act.py``. A spec is a tuple with one
entry per tensor dim: a mesh axis name, a tuple of names, or None
(PyTorch has no ``PartitionSpec``; ``sharding.placements`` turns a spec into
DTensor placements). The launcher installs a table for its mesh with
``use_activation_specs`` or the ``activation_specs`` context; with none
installed the models run unsharded.

The models call :func:`constrain` at the reference's points. A table whose
``_mesh`` key holds a ``DeviceMesh`` (``train.steps.build_step(mesh=)``
installs one) makes each call redistribute the DTensor activation to its
spec's placements on that mesh; with no table, no ``_mesh``, a name the
table lacks or a spec longer than the tensor's rank, the call returns its
input, as the reference's does. :func:`gathered` is the weight side of the
same table: the all-gather over the FSDP axes that GSPMD inserts before a
product with a data-sharded activation; :func:`summed` reduces a product's
partial sums as soon as it returns (the all-reduce after a row-parallel
product, Megatron's), so that the activations between the constraints
keep the layout the table gives them.

A table whose ``_ep_mesh`` key holds ``(mesh, axis)`` sends ``moe.moe_mlp``
down its expert-parallel path over that axis (``ep_mesh()``).
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.parallel.collectives import axis_sizes
from repro_torch.parallel.sharding import fit_spec, fsdp_axes, placements

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


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` redistributed to the placements of the installed spec ``name``
    on the table's ``_mesh`` (a spec entry whose axes do not divide the dim
    is dropped, as ``sharding.fit_spec`` drops it for params); ``x`` itself
    when no table, mesh or spec applies. Under a table with a mesh, ``x``
    must be a DTensor on it."""
    specs = getattr(_STATE, "specs", None)
    if not specs or specs.get(name) is None or specs.get("_mesh") is None:
        return x
    spec, mesh = specs[name], specs["_mesh"]
    if len(spec) > x.ndim:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain({name!r}): the installed table shards over a mesh, and "
                        f"the activation is a plain tensor of shape {tuple(x.shape)}")
    return x.redistribute(mesh, placements(fit_spec(spec, tuple(x.shape), mesh), mesh))


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product uses it: a DTensor gathered over its mesh's
    FSDP axes (``sharding.fsdp_axes``; its other placements kept, so a
    tensor-parallel weight stays split over ``model``); a plain tensor as
    it is. The gather's backward reduce-scatters the gradient back."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    fsdp = fsdp_axes(mesh)
    want = tuple(Replicate() if axis in fsdp else p
                 for axis, p in zip(mesh.mesh_dim_names, w.placements))
    return w if want == tuple(w.placements) else w.redistribute(mesh, want)


def summed(x: torch.Tensor) -> torch.Tensor:
    """A DTensor holding partial sums, all-reduced (each ``Partial``
    placement made ``Replicate``); anything else as it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                               for p in x.placements))
