"""GPipe microbatch pipeline: on one device, or over the ranks of a mesh axis.

The counterpart of ``repro/parallel/pipeline.py``, the paper's pipeline
structure: each stage owns the parameters of its layer range, and
microbatches stream from stage to stage. Both schedules run the reference's
``n_micro + n_stages - 1`` ticks and call every stage at every tick, so fill
and drain ticks compute on placeholder inputs as there.

Without a mesh the stages run one after another on the current device. With
one, rank ``i`` of the ``stage`` axis runs stage ``i`` only and hands its
output to rank ``i + 1`` after every tick (point to point), and the last
stage's outputs are replicated to every rank at the end (the reference's
masked ``psum``; here a broadcast from the last rank). The hand-off is
differentiable: its backward sends each received activation's cotangent
back to the rank it came from. The backward of the replication takes the
last rank's own cotangent and drops the others', so when every rank
computes the same loss on the replicated output the gradients equal those
of the sequential loss (a ``psum``'s transpose would sum them: ``n_stages``
times too much). The microbatches are a replicated input that stage 0 alone
reads: the backward broadcasts stage 0's cotangent of them to every rank
(the transpose of replication), so a replicated leaf upstream of the
pipeline, such as an embedding, gets the same gradient on every rank.

The transport follows the group's backend, chosen before the first send:
NCCL moves device tensors; gloo moves host copies (``collectives.on_host``).
Every rank posts the same sends and receives in the same order, forward
and backward: a chain of zero-size tokens through the entry, the hand-offs
and the replication makes autograd run their backwards in reverse order on
every rank. Whether the exchanges are recorded is agreed over the stage
group before the first hand-off (a MAX of each rank's need): when any rank's
stage weights or input need a gradient, the token requires grad on every
rank, so a rank whose own stage is frozen still posts its backward
exchanges.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import all_reduce, axis_group, on_host
from repro_torch.tree import leaves


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor,
                   mesh=None, axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(params, x)`` over the pipeline stages.

    x_microbatches: (n_micro, mb, ...) activations entering stage 0; every
    stage must keep the activation's shape and dtype. At tick t stage 0
    ingests microbatch t (the last one again once they run out), stage i
    takes what stage i-1 produced at tick t-1 (zeros at t = 0), and the last
    stage commits microbatch t - (n_stages - 1). Returns (n_micro, mb, ...).

    Without ``mesh``, ``stage_params`` is the sequence of every stage's
    params. With ``mesh`` (a ``DeviceMesh`` with an ``axis`` dim), it is
    this rank's stage's params only, and every rank gets the outputs.
    """
    if mesh is None:
        return _one_device(stage_fn, stage_params, x_microbatches)
    group, n_stages, i = axis_group(mesh, axis)
    link = _Link(group, n_stages, i)
    n_micro = x_microbatches.shape[0]
    carry = torch.zeros_like(x_microbatches[0])
    record = link.any_rank(_needs_grad(stage_params, x_microbatches), x_microbatches.device)
    token = torch.zeros(0, device=x_microbatches.device, requires_grad=record)
    mbs, token = _Enter.apply(x_microbatches, token, link)
    outs = []
    for t in range(n_micro + n_stages - 1):
        x = mbs[min(t, n_micro - 1)] if i == 0 else carry
        y = stage_fn(stage_params, x)
        if i == n_stages - 1 and t >= n_stages - 1:
            outs.append(y)
        carry, token = _Handoff.apply(y, token, link)
    # the other ranks' outputs are placeholders, tied to the token chain so that
    # every rank's loss reaches its own hand-offs in the backward
    local = torch.stack(outs) if outs else x_microbatches.new_zeros(
        (n_micro,) + tuple(y.shape), dtype=y.dtype)
    return _Replicate.apply(local, token, link)


def _one_device(stage_fn: Callable, stage_params: Sequence,
                x_microbatches: torch.Tensor) -> torch.Tensor:
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


class _Link:
    """This rank's place on the stage axis and the transport to its neighbours."""

    def __init__(self, group, n_stages: int, index: int):
        self.group, self.n, self.i = group, n_stages, index
        self.host = on_host(group)
        self.prev = dist.get_global_rank(group, index - 1) if index > 0 else None
        self.next = dist.get_global_rank(group, index + 1) if index < n_stages - 1 else None
        self.first = dist.get_global_rank(group, 0)
        self.last = dist.get_global_rank(group, n_stages - 1)

    def exchange(self, send: torch.Tensor | None, to, like: torch.Tensor, frm) -> torch.Tensor:
        """Send ``send`` to global rank ``to`` and receive a tensor shaped as
        ``like`` from ``frm`` (either may be None), both posted before either
        is waited on; zeros when nothing is received."""
        out = torch.zeros_like(like)
        ops, buf = [], None
        if to is not None:
            payload = send.detach().contiguous()
            if self.host:
                payload = payload.cpu()
            ops.append(dist.P2POp(dist.isend, _bytes(payload), to, self.group))
        if frm is not None:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if self.host else like.device)
            ops.append(dist.P2POp(dist.irecv, _bytes(buf), frm, self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if buf is not None:
            out.copy_(buf)
        return out

    def any_rank(self, flag: bool, device) -> bool:
        """Whether ``flag`` holds on any rank of the stage group (reduced on
        ``device``, which NCCL needs to be the card)."""
        t = torch.tensor([float(flag)], device=device)
        return bool(all_reduce(t, self.group, dist.ReduceOp.MAX)[0])

    def broadcast(self, t: torch.Tensor, src) -> torch.Tensor:
        """Global rank ``src``'s ``t`` on every rank, as raw bytes (gloo reduces
        and broadcasts no bf16 on some builds)."""
        buf = t.detach().to("cpu" if self.host else t.device, copy=True).contiguous()
        dist.broadcast(_bytes(buf), src=src, group=self.group)
        return buf.to(t.device)


def _needs_grad(stage_params, x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in [x, *leaves(stage_params)])


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view (sends and receives
    through it act on ``t``)."""
    return t.reshape(-1).view(torch.uint8)


class _Enter(torch.autograd.Function):
    """Forward: the microbatches as they are. Backward: stage 0's cotangent
    of them on every rank (the other stages read placeholders)."""

    @staticmethod
    def forward(ctx, x, token, link):
        ctx.link = link
        return x.view_as(x), token.clone()

    @staticmethod
    def backward(ctx, g_x, g_token):
        link = ctx.link
        return link.broadcast(g_x, link.first), g_token, None


class _Handoff(torch.autograd.Function):
    """Forward: send ``y`` to the next stage, receive the previous stage's
    output (zeros on stage 0). Backward: send the received tensor's
    cotangent back to the previous stage, receive ``y``'s from the next
    (zeros on the last stage). ``token`` orders the hand-offs' backwards."""

    @staticmethod
    def forward(ctx, y, token, link):
        ctx.link = link
        carry = link.exchange(y, link.next, y, link.prev)
        return carry, token.clone()

    @staticmethod
    def backward(ctx, g_carry, g_token):
        link = ctx.link
        g_y = link.exchange(g_carry, link.prev, g_carry, link.next)
        return g_y, g_token, None


class _Replicate(torch.autograd.Function):
    """Forward: the last stage's ``local`` on every rank. Backward: the last
    rank passes its own cotangent to ``local``; the other ranks' ``local`` is
    a placeholder and takes none."""

    @staticmethod
    def forward(ctx, local, token, link):
        ctx.last = link.i == link.n - 1
        return link.broadcast(local, link.last)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None), torch.zeros(0, device=g.device), None


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B // n_micro, ...)"""
    b = x.shape[0]
    if n_micro < 1 or b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
