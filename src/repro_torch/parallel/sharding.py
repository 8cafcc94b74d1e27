"""Sharding rules: param, cache and batch specs per arch family.

The counterpart of ``repro/parallel/sharding.py``, rule for rule:

* ``model`` mesh axis: tensor parallel (Megatron column/row), expert
  parallel for MoE, and the sequence-sharded KV cache of decode;
* ``data`` (and ``pod`` when present): data parallel AND fully-sharded
  params and optimizer state (FSDP/ZeRO-3: weights sharded along their
  large non-TP dim).

Rules are looked up by the name of each leaf (the last key of its path),
with a context check for MoE expert tensors; leading stack dims (scanned
layers, zamba groups) are padded with None. A spec is a tuple with one
entry per tensor dim (an axis name, a tuple of names, or None), as in
``parallel.act``; ``placements`` turns one into DTensor placements for a
``DeviceMesh``, and ``distribute`` places a tree by its specs. Axis sizes
come from a ``DeviceMesh`` or from a plain ``{axis: size}`` mapping
(``collectives.axis_sizes``), so the rules can be evaluated for a mesh
wider than the ranks at hand. Leaves only need a
``.shape`` (meta tensors do).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.optim.adamw import OptState
from repro_torch.parallel.collectives import axis_sizes
from repro_torch.tree import map_tree, map_with_path

FSDP = "__fsdp__"  # placeholder resolved to ("pod", "data") or ("data",)


def fsdp_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def dp_axes(mesh) -> tuple[str, ...]:
    return fsdp_axes(mesh)


def dp_spec(mesh):
    """The data axes as one spec entry: ``"data"``, or ``("pod", "data")``."""
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


# name -> spec template (trailing dims; leading stack dims padded with None)
_RULES: dict[str, tuple] = {
    # embeddings / heads
    "embed": (FSDP, "model"),
    "lm_head": (FSDP, "model"),
    "pos_dec": (None, "model"),
    "projector": (None, "model"),
    # attention
    "wq": (FSDP, "model"), "wk": (FSDP, "model"), "wv": (FSDP, "model"),
    "wo": ("model", FSDP),
    # dense mlp
    "w_up": (FSDP, "model"), "w_gate": (FSDP, "model"),
    "w_down": ("model", FSDP),
    # moe
    "router": (FSDP, None),
    # mamba2
    "in_proj": (FSDP, "model"), "bc_proj": (FSDP, None),
    "dt_proj": (FSDP, None), "out_proj": ("model", FSDP),
    "conv_w": (None, "model"),
    # xlstm gates
    "wi": (FSDP, None), "wf": (FSDP, None),
    "w_gates": (FSDP, "model"), "r_gates": (FSDP, "model"),
}

# MoE expert tensors (rank 3 before stacking): EP over `model`, FSDP inside.
_MOE_RULES: dict[str, tuple] = {
    "w_up": ("model", FSDP, None),
    "w_gate": ("model", FSDP, None),
    "w_down": ("model", FSDP, None),
}


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def fit_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop trailing mesh axes from any dim that they do not divide (an
    even shard needs exact divisibility): e.g. whisper's vocab 51865 cannot
    take a 16-way ``model`` axis, and batch-1 decode cannot take the DP axes.
    Entries past the tensor's rank become None."""
    sizes = axis_sizes(mesh)
    out = []
    for d, entry in enumerate(spec):
        if entry is None or d >= len(shape):
            out.append(None if d >= len(shape) else entry)
            continue
        axes = tuple(entry) if isinstance(entry, tuple) else (entry,)
        while axes and shape[d] % _prod(sizes[a] for a in axes) != 0:
            axes = axes[:-1]
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(out)


def _resolve(template: tuple, mesh) -> tuple:
    fs = fsdp_axes(mesh)
    return tuple((fs if len(fs) > 1 else fs[0]) if t == FSDP else t for t in template)


def param_pspecs(params_or_shapes: Any, mesh) -> Any:
    """A spec tree matching the params tree."""

    def leaf_spec(path: str, leaf):
        names = path.split("/")
        name = names[-1]
        rank = len(leaf.shape)
        is_moe_expert = "moe" in names and "shared" not in names and name in _MOE_RULES
        rule = _MOE_RULES[name] if is_moe_expert else _RULES.get(name)
        if rule is None or rank < len(rule):
            return ()  # scales, biases, scalars: replicated
        pad = (None,) * (rank - len(rule))
        return fit_spec(pad + _resolve(rule, mesh), tuple(leaf.shape), mesh)

    return map_with_path(leaf_spec, params_or_shapes)


def cache_pspecs(cfg: ArchConfig, cache_shapes: Any, mesh) -> Any:
    """KV/state cache specs. Dense KV caches are sequence-sharded along
    ``model`` (distributed decode attention), batch along the DP axes.
    Recurrent states shard heads."""
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]

    def leaf_spec(path: str, leaf) -> tuple:
        name = path.split("/")[-1]
        rank = len(leaf.shape)
        if cfg.family == "ssm":
            # per-layer list caches: c (B,H,hd,hd) / n (B,H,hd) / m (B,H) /
            # h (B,D) / c_slstm (B,D)
            return (dpa,) + (None,) * (rank - 1)
        if cfg.family == "hybrid":
            if name in ("k", "v"):   # (G, B, S, kv, hd)
                return (None, dpa, "model", None, None)
            if name == "conv":       # (G, per, B, W-1, d_in)
                return (None, None, dpa, None, "model")
            if name == "ssm":        # (G, per, B, n_h, hd, N)
                return (None, None, dpa, "model", None, None)
        if name in ("k", "v", "xk", "xv"):  # (L, B, S, kv, hd)
            return (None, dpa, "model", None, None)
        return ()

    return map_with_path(lambda path, leaf: fit_spec(leaf_spec(path, leaf),
                                                     tuple(leaf.shape), mesh), cache_shapes)


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, specs: dict, mesh) -> dict:
    """Input specs matching an input-spec dict (name -> leaf with ``.shape``;
    ``cache`` -> a cache tree)."""
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_pspecs(cfg, v, mesh)
        elif k == "pos":
            out[k] = fit_spec((dpa,), tuple(v.shape), mesh)
        else:
            out[k] = fit_spec((dpa,) + (None,) * (len(v.shape) - 1), tuple(v.shape), mesh)
    return out


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements for ``spec`` on ``mesh`` (the counterpart of the
    reference's ``NamedSharding``): per mesh dim, ``Shard(d)`` for the tensor
    dim ``d`` whose entry names that axis, else ``Replicate()``. A tensor dim
    named by several axes is split by them in mesh-dim order."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if axis == entry or (isinstance(entry, tuple) and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def opt_pspecs(p_specs) -> OptState:
    """Specs of ``adamw.OptState`` for params of ``p_specs``: both moments as
    their params (the reference's ``OptState(mu=p_specs, nu=p_specs,
    count=P())``); the step count None, which ``distribute`` leaves a plain
    tensor, the same on every rank."""
    return OptState(mu=p_specs, nu=p_specs, count=None)


def distribute(tree, specs, mesh):
    """``tree`` on ``mesh``, leaf by leaf by the spec at the same place of
    ``specs``. A plain leaf, the same global tensor on every rank, becomes
    the DTensor of this rank's shard, sliced with no communication
    (``src_data_rank=None``) and copied, so the global leaf can be freed; a
    DTensor leaf is redistributed to the spec's placements (a no-op where
    they already agree). A leaf whose spec is None stays as it is."""
    return map_tree(lambda leaf, spec: leaf if spec is None else
                    place(leaf, mesh, placements(spec, mesh)),
                    tree, specs, is_leaf=lambda x: isinstance(x, torch.Tensor))


def place(leaf: torch.Tensor, mesh, want: tuple) -> DTensor:
    """``leaf`` as a DTensor of ``want`` placements on ``mesh``: a plain
    tensor, the same global tensor on every rank, sliced to this rank's
    shard with no communication and copied (so the global tensor can be
    freed); a DTensor redistributed, where its placements differ."""
    if isinstance(leaf, DTensor):
        return leaf if tuple(leaf.placements) == tuple(want) else leaf.redistribute(mesh, want)
    out = distribute_tensor(leaf, mesh, want, src_data_rank=None)
    local = out.to_local()
    # one storage, compared by identity: a fake tensor (the dry run's) has no data pointer
    if local.untyped_storage()._cdata == leaf.untyped_storage()._cdata:
        out = DTensor.from_local(local.clone(), mesh, want, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out



def is_spec(x) -> bool:
    """Whether ``x`` is a leaf of a spec tree: a spec (a plain tuple; the
    trees' nodes are dicts, lists and NamedTuples) or None."""
    return x is None or (isinstance(x, tuple) and not hasattr(x, "_fields"))


def shardings(specs, mesh):
    """The (mesh, placements) pair of each spec of a tree (None stays None):
    the counterpart of the reference's tree of ``NamedSharding``, what
    ``checkpoint.store.restore(placements=)`` takes."""
    return map_tree(lambda spec: None if spec is None else (mesh, placements(spec, mesh)),
                    specs, is_leaf=is_spec)
