"""int8 gradient compression with error feedback, and its all-reduce.

The counterpart of ``repro/parallel/collectives.py``: per-tensor symmetric
int8 quantization; ``compress_grads``, which returns the grads in their
dequantized form (so the optimizer path is unchanged) and the new error
feedback (the Trainer's ``grad_compression``); and ``compressed_psum``,
where the int8 payload is what the all-reduce moves: each rank quantizes
``g + err`` with its own scale, the int8 values are summed as int32 and the
scales reduced by max, and the sum is dequantized with the max scale.

``blocking_functional_collectives`` runs DTensor's collectives (the
functional ops of ``torch.ops._c10d_functional``) as blocking
``torch.distributed`` calls, for gloo groups holding CUDA tensors: gloo
runs every blocking collective on them, but the functional ops'
``wait_tensor`` ends the process with a segmentation fault (torch 2.11 on
the H100 machine, four gloo ranks sharing the card).

``on_host`` picks the transport of a process group from its backend, before
anything is sent: gloo moves host copies of device tensors, NCCL moves the
device tensors themselves. ``axis_group`` and ``axis_sizes`` read a mesh
axis's process group and the axes' sizes; ``axis_sizes`` also takes a plain
``{axis: size}`` mapping, so that the sharding rules can be checked for a
mesh wider than the ranks at hand.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

from repro_torch.tree import map_tree


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping that stands for one."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_group(mesh, axis: str):
    """(process group, size, this rank's index) along one axis of a ``DeviceMesh``."""
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"mesh axes {names} hold no axis {axis!r}")
    d = names.index(axis)
    return mesh.get_group(d), mesh.size(d), mesh.get_local_rank(d)


def on_host(group) -> bool:
    """Whether collectives of ``group`` move host copies (gloo) or device
    tensors (NCCL); any other backend raises."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return True
    if backend == "nccl":
        return False
    raise ValueError(f"no transport for process-group backend {backend!r}")


def quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params):
    return map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _unzip(pairs):
    """A tree whose leaves became (a, b) pairs -> (tree of a, tree of b). The
    grads' trees are nested dicts."""
    def pick(tree, i):
        return {k: pick(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    return pick(pairs, 0), pick(pairs, 1)


def compress_grads(grads, err):
    """grads + err -> (quantized grads in dequantized form, new err)."""
    def one(g, e):
        acc = g.float() + e
        q, scale = quantize_int8(acc)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), acc - deq

    return _unzip(map_tree(one, grads, err))


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ranks of ``group``, on ``t``'s device; ``t``
    itself is left as it was (a host copy moves under gloo, a device copy
    under NCCL)."""
    buf = t.detach().to("cpu" if on_host(group) else t.device, copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def compressed_psum(grads, group, err):
    """Sum ``grads`` over the ranks of ``group`` with int8 on the wire:
    -> (the sum, in each grad's dtype; the new error feedback).

    Per leaf: ``acc = g + err`` in fp32 is quantized with this rank's scale;
    the int8 values are all-reduced as int32 (SUM) and the scales by MAX;
    the sum is the int32 total times the max scale. The new error is
    ``acc - dequantize(q, scale)`` with this rank's own scale.
    """
    def one(g, e):
        acc = g.float() + e
        q, scale = quantize_int8(acc)
        total = all_reduce(q.to(torch.int32), group)
        scale_max = all_reduce(scale.reshape(1), group, dist.ReduceOp.MAX)[0]
        deq = total.float() * scale_max
        return deq.to(g.dtype), acc - dequantize_int8(q, scale)

    return _unzip(map_tree(one, grads, err))


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
               "product": dist.ReduceOp.PRODUCT, "avg": dist.ReduceOp.SUM}
_BLOCKING: dict = {}  # device type -> the torch.library registration that holds the kernels


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name) if isinstance(name, str) else name


def _reduced(t: torch.Tensor, reduce_op: str, group) -> torch.Tensor:
    if reduce_op == "avg":
        t.div_(dist.get_world_size(group))
    return t


def _all_gather(x, group_size, group_name):
    # gathered on host copies and copied to the device once: gloo's own
    # gather of CUDA tensors stages the whole result in a second device
    # buffer (torch 2.11), twice the result's bytes at once
    host = x.detach().to("cpu").contiguous()
    out = host.new_empty((host.shape[0] * group_size, *host.shape[1:]))
    dist.all_gather_into_tensor(out, host, group=_group(group_name))
    return out.to(x.device)


def _reduce_scatter(x, reduce_op, group_size, group_name):
    out = x.new_empty((x.shape[0] // group_size, *x.shape[1:]))
    group = _group(group_name)
    dist.reduce_scatter_tensor(out, x.contiguous(), op=_REDUCE_OPS[reduce_op], group=group)
    return _reduced(out, reduce_op, group)


def _all_reduce(x, reduce_op, group_name):
    out, group = x.clone(memory_format=torch.contiguous_format), _group(group_name)
    dist.all_reduce(out, op=_REDUCE_OPS[reduce_op], group=group)
    return _reduced(out, reduce_op, group)


def _all_to_all(x, output_split_sizes, input_split_sizes, group_name):
    rows = sum(output_split_sizes) if output_split_sizes else x.shape[0]
    out = x.new_empty((rows, *x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes or None,
                           input_split_sizes or None, group=_group(group_name))
    return out


def blocking_functional_collectives(device_type: str = "cuda") -> None:
    """Register blocking kernels for ``device_type`` under the functional
    collectives DTensor calls (all-gather, reduce-scatter, all-reduce, their
    coalesced forms, all-to-all): each is the ``torch.distributed`` call of
    the same name on the op's group (the all-gather on host copies),
    complete when it returns, and
    ``wait_tensor`` returns its input. The values are the collectives'
    own. Every group of the process takes these kernels, so call it where
    all of them are gloo groups (``launch.mesh.make_mesh`` does, for CUDA
    meshes over gloo). Idempotent."""
    if device_type in _BLOCKING:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    lib.impl("all_gather_into_tensor", _all_gather, key)
    lib.impl("all_gather_into_tensor_coalesced",
             lambda xs, n, g: [_all_gather(x, n, g) for x in xs], key)
    lib.impl("reduce_scatter_tensor", _reduce_scatter, key)
    lib.impl("reduce_scatter_tensor_coalesced",
             lambda xs, op, n, g: [_reduce_scatter(x, op, n, g) for x in xs], key)
    lib.impl("all_reduce", _all_reduce, key)
    lib.impl("all_reduce_coalesced", lambda xs, op, g: [_all_reduce(x, op, g) for x in xs], key)
    lib.impl("all_to_all_single", _all_to_all, key)
    lib.impl("wait_tensor", lambda t: t, key)
    _BLOCKING[device_type] = lib
