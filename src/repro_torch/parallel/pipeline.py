"""GPipe microbatch pipeline on one device.

The counterpart of ``repro/parallel/pipeline.py``: the same fill/steady/
drain schedule, tick by tick, with the stages run one after another on the
current device instead of on a ``stage`` mesh axis. Each stage is called at
every one of the ``n_micro + n_stages - 1`` ticks, as in the reference, so
fill and drain ticks compute on the same placeholder inputs there too.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def pipeline_apply(stage_fn: Callable, stage_params: Sequence,
                   x_microbatches: torch.Tensor) -> torch.Tensor:
    """Run ``stage_fn(params_i, x)`` over the stages ``i = 0 .. n_stages-1``.

    x_microbatches: (n_micro, mb, ...) activations entering stage 0; every
    stage must keep the activation's shape. At tick t stage 0 ingests
    microbatch t (the last one again once they run out), stage i takes what
    stage i-1 produced at tick t-1 (zeros at t = 0), and the last stage
    commits microbatch t - (n_stages - 1). Returns (n_micro, mb, ...).
    """
    n_stages = len(stage_params)
    n_micro = x_microbatches.shape[0]
    carry = [torch.zeros_like(x_microbatches[0])] * n_stages  # input of stage i
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        ys = [stage_fn(stage_params[i],
                       x_microbatches[min(t, n_micro - 1)] if i == 0 else carry[i])
              for i in range(n_stages)]
        if t >= n_stages - 1:
            outs[t - (n_stages - 1)] = ys[-1]
        carry = [None] + ys[:-1]  # stage i hands its output to stage i + 1
    return torch.stack(outs)


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B // n_micro, ...)"""
    b = x.shape[0]
    if n_micro < 1 or b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
