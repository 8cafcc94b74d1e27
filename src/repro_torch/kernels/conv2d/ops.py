"""Checked entry point of the convolution ('same' padding, stride 1).

The counterpart of ``repro/kernels/conv2d/ops.py::conv2d``. A CUDA tensor
launches the CUDA kernel (or raises) on the route ``conv2d.plan_for``
picks; a CPU tensor takes the plain version ``conv2d_ref``.
``conv2d.launches`` counts kernel launches, one per call, and
``conv2d.launches_by_route`` splits them by route (``wgmma``, ``tf32x3``,
``direct``).
It raises when autograd would record the call (``refuse_grad``): the
kernel has no backward, and training takes the plain route.
While a profiler records, a call is the span ``kernels.conv2d``
(``repro_torch.obs.hotpath``), from the checks through the launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_dtensor, refuse_grad
from repro_torch.obs import hotpath
from .conv2d import ROUTES, launch, plan_for
from .ref import conv2d_ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535  # CUDA's limit on grid y (K / 64) and z (N)


def _check(x, w) -> None:
    if not (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)):
        raise TypeError("conv2d takes two tensors")
    refuse_dtensor("conv2d", x, w)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d takes x (N, C, H, W) and w (K, C, R, S); "
                         f"got shapes {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"conv2d takes float32 or bfloat16, the same for x and w; "
                         f"got {x.dtype} and {w.dtype}")
    if x.device != w.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv2d takes x and w on one CPU or CUDA device; "
                         f"got {x.device} and {w.device}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"input channels differ: x has {x.shape[1]}, w has {w.shape[1]}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError("conv2d takes non-empty tensors")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d takes contiguous tensors")
    if x.shape[0] > _MAX_GRID_YZ or -(-w.shape[0] // 64) > _MAX_GRID_YZ:
        raise ValueError(f"batch {x.shape[0]} or output channels {w.shape[0]} "
                         f"exceed the kernel's grid")


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, C, H, W); w (K, C, R, S) -> (N, K, H, W), 'same' pad, stride 1."""
    if hotpath.recording():
        with hotpath.span("kernels.conv2d"):
            return _conv2d(x, w)
    return _conv2d(x, w)


def _conv2d(x, w):
    _check(x, w)
    refuse_grad("conv2d", x, w)
    if x.device.type == "cpu":
        return conv2d_ref(x, w)
    out = torch.empty((x.shape[0], w.shape[0], x.shape[2], x.shape[3]),
                      dtype=x.dtype, device=x.device)
    p = plan_for(x, w)
    launch(x, w, out, p)
    conv2d.launches += 1
    conv2d.launches_by_route[p.route] += 1
    return out


conv2d.launches = 0
conv2d.launches_by_route = dict.fromkeys(ROUTES, 0)
