"""AdamW with gradient clipping and a warmup-cosine schedule; states are
trees mirroring the params.

The counterpart of ``repro/optim/adamw.py``, with the reference's
arithmetic: the clip scale from the fp32 global norm of the grads, then
``b1·m + (1−b1)·g``, ``b2·v + (1−b2)·g²`` and
``p − lr·((m/c1)/(sqrt(v/c2)+eps) + wd·p)``, each product and sum rounded
to fp32 on its own (no fused multiply-add), and the schedule, ``c1`` and
``c2`` taken in fp32 tensors from the step count as the reference takes
them from ``count.astype(float32)``.

One difference of idiom: ``apply`` updates the params, ``mu``, ``nu`` and
``count`` in place, leaf by leaf and in slices of ``_SLICE`` elements, and
returns the same objects. XLA donates the reference's buffers; eager
PyTorch cannot, and an out-of-place update of StarCoder2-3B (fp32 params,
grads, mu and nu: 4 x 12.7 GB) would add about 38 GB of new tensors. The
grads are scaled in place too: ``apply`` consumes them.

DTensor params (a sharded train step) are updated shard by shard: each
gradient is first moved to its param's placements (where the reduction
over the data axes happens, unless ``StepOptions.constrain_grads`` did it
already), the global norm sums each leaf's squares over the mesh, and the
update runs on each rank's local shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import leaves, map_tree

_SLICE = 1 << 26  # elements a slice: each temporary is at most 256 MB in fp32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor  # 0-d int32


def init(params) -> OptState:
    """Zero moments in fp32 beside each param, and a zero int32 count on
    the params' device."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = leaves(params)[0].device
    return OptState(mu=map_tree(zeros, params), nu=map_tree(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then a cosine from ``lr`` down to ``min_lr_frac * lr``;
    ``step`` is a float32 tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _slices(t: torch.Tensor):
    return t.view(-1).split(_SLICE)


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    if isinstance(x, DTensor):  # the whole leaf's, each element counted once
        return torch.sum(torch.square(x.float())).full_tensor()
    return sum(torch.sum(torch.square(s.float())) for s in _slices(x))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(_sum_sq(x) for x in leaves(tree)))


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient moved to its param's placements (a partial sum
    over the data axes reduced, scattered where the param is sharded)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _shard(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def apply(grads, state: OptState, params, cfg: AdamWConfig):
    """Returns (params, state, stats), the first two updated in place."""
    grads = map_tree(placed_like, grads, params)
    state.count.add_(1)
    count = state.count.float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    c1 = 1 - torch.pow(cfg.b1, count)
    c2 = 1 - torch.pow(cfg.b2, count)
    lr = schedule(cfg, count)

    for leaf in zip(leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu)):
        p, g, m, v = (_shard(t) for t in leaf)
        g = g.contiguous()  # a transposed use (a tied head) leaves a transposed gradient
        if not p.is_contiguous():
            raise ValueError("adamw.apply updates contiguous params in place")
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            gs = gs.float().mul_(scale)
            ms.mul_(cfg.b1).add_(torch.mul(gs, 1 - cfg.b1))
            vs.mul_(cfg.b2).add_(torch.mul(gs, 1 - cfg.b2).mul_(gs))
            den = torch.sqrt(vs / c2).add_(cfg.eps)
            p32 = ps.float()
            step = (ms / c1).div_(den).add_(torch.mul(p32, cfg.weight_decay)).mul_(lr)
            if ps.dtype == torch.float32:
                ps.sub_(step)
            else:
                ps.copy_(p32 - step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
