"""The paper's own workload in PyTorch: VGG-like CNNs, run either as a plain
sequential forward or through the DNNExplorer *hybrid* execution plan: the
first SP layers as a microbatch pipeline head (the paper's pipeline
structure) and the rest through one reusable apply (the generic structure).

The counterpart of ``repro/models/cnn.py``. Every conv goes through the
hand-written direct-conv kernel (``repro_torch.kernels.conv2d``), the
pipeline compute engine of the paper, on the hybrid path too.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.netinfo import NetInfo
from repro_torch.device import resolve as _device
from repro_torch.kernels.conv2d.ops import conv2d
from repro_torch.kernels.conv2d.ref import conv2d_ref
from repro_torch.parallel.collectives import axis_group
from repro_torch.parallel.pipeline import pipeline_apply, split_microbatches


def init_vgg(net: NetInfo, *, generator: torch.Generator, device="cuda",
             dtype=torch.float32) -> list:
    """He-normal conv weights (K, C, R, S) for every major layer, None for pools."""
    device = _device(device)
    params = []
    for l in net.layers:
        if l.kind == "pool":
            params.append(None)
            continue
        w = torch.randn((l.k, l.c, l.r, l.s), generator=generator,
                        device=generator.device, dtype=torch.float32)
        w *= (2.0 / (l.c * l.r * l.s)) ** 0.5
        params.append(w.to(device=device, dtype=dtype))
    return params


def params_from_jax(params_np: Sequence, *, device="cuda", dtype=None) -> list:
    """The JAX package's parameter list (numpy arrays, None for pools) as tensors.

    ``dtype=None`` keeps each array's dtype; JAX's bfloat16 arrays become
    ``torch.bfloat16``.
    """
    device = _device(device)
    out = []
    for p in params_np:
        if p is None:
            out.append(None)
            continue
        a = np.array(p)  # a writable copy: JAX hands out read-only buffers
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through fp32
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out.append(t.to(device=device, dtype=dtype or t.dtype))
    return out


def layer_apply(x: torch.Tensor, w, layer, use_kernel: bool = True) -> torch.Tensor:
    """One major layer (+ fused ReLU) or pool."""
    if layer.kind == "pool":
        # reduce_window(max, -inf) over VALID windows
        return F.max_pool2d(x, (layer.r, layer.s), stride=layer.stride)
    y = conv2d(x, w) if use_kernel else conv2d_ref(x, w)
    return torch.relu_(y)


def forward(params, net: NetInfo, x: torch.Tensor, *, use_kernel: bool = True):
    """Plain sequential forward: x (N, 3, H, W) -> feature map.

    ``use_kernel=False`` runs the plain ``conv2d_ref``: the oracle of the
    kernel path, for tests and the chip smoke run.
    """
    for w, l in zip(params, net.layers):
        x = layer_apply(x, w, l, use_kernel)
    return x


# ---------------------------------------------------------------------------
# Hybrid execution: the paper's paradigm as an execution plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HybridPlan:
    """Execution plan from an RAV: layers [0, sp) (pools included) run as
    dedicated pipeline stages; layers [sp, N) run through one generic apply."""
    sp: int
    n_micro: int


def _homogeneous(layers) -> bool:
    """Convs whose weights share one shape: one stage function serves them all."""
    return (all(l.kind == "conv" for l in layers)
            and len({(l.k, l.c, l.r, l.s) for l in layers}) == 1)


def hybrid_forward(params, net: NetInfo, x: torch.Tensor, plan: HybridPlan, *,
                   pipelined: bool = False, mesh=None, use_kernel: bool = True) -> torch.Tensor:
    """Run the net under a hybrid plan.

    A head of ``sp > 1`` convs whose weights share one shape (the paper's
    deepened VGG groups) runs through the GPipe schedule of
    ``pipeline_apply`` with ``layers[0]`` as the stage layer: on one device
    with ``pipelined=True``, or over the ranks of ``mesh``'s ``stage`` axis,
    one stage a rank (``sp`` must equal the axis's size), where rank ``i``
    reads only ``params[i]`` of the head and the others may be None.
    Otherwise, and for a head holding a pool (which the reference's mesh
    route cannot run: ROADMAP.md queue 3, fault 1), the head runs layer by
    layer. The tail always does, on every rank. ``use_kernel=False`` runs
    the plain ``conv2d_ref`` (autograd goes through it; the kernel has no
    backward).
    """
    if pipelined and mesh is not None:
        raise ValueError("pipelined=True runs the head on one device; a mesh spreads it "
                         "over ranks: pass one or the other")
    layers = list(net.layers)
    sp = plan.sp
    head = params[:sp]

    def stage(w, h):
        return layer_apply(h, w, layers[0], use_kernel)

    if mesh is not None and sp > 1:
        _, n_stages, rank = axis_group(mesh, "stage")
        if sp != n_stages:
            raise ValueError(f"one pipeline stage per head layer: sp {sp}, {n_stages} stages")
    if (pipelined or mesh is not None) and sp > 1 and _homogeneous(layers[:sp]):
        mbs = split_microbatches(x, plan.n_micro)
        y = (pipeline_apply(stage, head, mbs) if mesh is None
             else pipeline_apply(stage, head[rank], mbs, mesh, axis="stage"))
        x = y.reshape((-1,) + tuple(y.shape[2:]))
    else:
        for w, l in zip(head, layers[:sp]):
            x = layer_apply(x, w, l, use_kernel)

    # generic structure: one reusable apply, recurrent over the tail
    for w, l in zip(params[sp:], layers[sp:]):
        x = layer_apply(x, w, l, use_kernel)
    return x
