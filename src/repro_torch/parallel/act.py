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
spec's placements on that mesh, and its gradient in the backward pass; with no table, no ``_mesh``, a name the
table lacks or a spec longer than the tensor's rank, the call returns its
input, as the reference's does. :func:`gathered` is the weight side of the
same table: the all-gather over the FSDP axes that GSPMD inserts before a
product with a data-sharded activation; :func:`summed` reduces a product's
partial sums as soon as it returns (the all-reduce after a row-parallel
product, Megatron's), so that the activations between the constraints
keep the layout the table gives them. :func:`local_apply` runs a
computation DTensor has no sharding rule for (a scan, a dispatch) on each
rank's local shards, at placements its caller names.

A table whose ``_ep_mesh`` key holds ``(mesh, axis)`` sends ``moe.moe_mlp``
down its expert-parallel path over that axis (``ep_mesh()``).
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.parallel.collectives import axis_sizes
from repro_torch.parallel.sharding import dp_spec, fit_spec, fsdp_axes, placements

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


def installed_specs() -> dict | None:
    """This thread's installed activation spec table, or None."""
    return getattr(_STATE, "specs", None)


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
    return _Pinned.apply(x, placements(fit_spec(spec, tuple(x.shape), mesh), mesh))


def pinned(x: torch.Tensor) -> torch.Tensor:
    """A DTensor whose gradient takes its forward placements (``_Pinned``);
    a plain tensor as it is. For a reshape's output: DTensor's backward may
    hand it a gradient split along a dim the reshape merges with another
    split one, which it cannot take back apart on fake tensors."""
    return _Pinned.apply(x, tuple(x.placements)) if isinstance(x, DTensor) else x


class _Pinned(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too: the
    transpose of the reference's ``with_sharding_constraint`` is the same
    constraint on the cotangent, so the gradients between the constraints
    keep the table's layout (DTensor's own backward would leave them as the
    ops behind them placed them)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return _dense(x.redistribute(x.device_mesh, want))

    @staticmethod
    def backward(ctx, g):
        return _dense(g.redistribute(g.device_mesh, ctx.want)), None


def _dense(t: DTensor) -> DTensor:
    """``t`` with a contiguous local tensor: a shard cut from a replicated
    tensor along a later dim is a strided view, which a later ``view`` of
    the DTensor (its global strides say contiguous) cannot take."""
    local = t.to_local()
    if local.is_contiguous():
        return t
    return DTensor.from_local(local.contiguous(), t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


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


def fitted_placements(spec: tuple, t: torch.Tensor) -> tuple:
    """The placements of ``spec`` for the DTensor ``t``, each entry whose axes
    do not divide its dim dropped (``sharding.fit_spec``)."""
    return placements(fit_spec(spec, tuple(t.shape), t.device_mesh), t.device_mesh)


def batch_heads_spec(mesh, ndim: int, heads: int | None = None) -> tuple:
    """The spec of a (B, ..., H, ...) tensor split over the data axes along
    its batch and over ``model`` along dim ``heads`` (None: not split)."""
    spec = [dp_spec(mesh)] + [None] * (ndim - 1)
    if heads is not None:
        spec[heads] = "model"
    return tuple(spec)


def local_apply(fn, args: tuple, arg_placements: tuple, out_placements):
    """``fn`` on this rank's local shards: each DTensor of ``args`` moved to
    its entry of ``arg_placements`` (None leaves it as it is; a plain
    argument passes through), ``fn`` called on the local tensors, and its
    output (a tensor or a tuple of them) made DTensors of ``out_placements``
    (one tuple of placements, or one per output).

    Differentiable. A mesh dim along which some argument is sharded splits
    the work: an argument replicated along it (a weight beside split
    activations) gets, on each rank, its part of the gradient's sum
    (``Partial``); every other gradient has its forward placements."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    moved = [a.redistribute(mesh, pl) if isinstance(a, DTensor) and pl is not None else a
             for a, pl in zip(args, arg_placements)]
    split = [any(isinstance(a, DTensor) and a.placements[d].is_shard() for a in moved)
             for d in range(mesh.ndim)]
    local = []
    for a in moved:
        if isinstance(a, DTensor):
            grad = tuple(Partial() if split[d] and p.is_replicate() else p
                         for d, p in enumerate(a.placements))
            a = a.to_local(grad_placements=grad)
        local.append(a)
    out = fn(*local)
    if not isinstance(out, tuple):
        return DTensor.from_local(out, mesh, out_placements, run_check=False)
    return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                 for o, pl in zip(out, out_placements))
