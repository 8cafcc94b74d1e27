"""Hybrid execution plan for transformer LMs: the paper's paradigm applied
to the dense LM.

The counterpart of ``repro/train/hybrid.py``. The DSE's split point SP
sends the first SP decoder blocks through dedicated pipeline stages (the
paper's pipeline structure: microbatches streaming through the stages)
and the remaining blocks through the ordinary loop over blocks (the
generic, reusable structure). The reference's ``mesh`` (a ``stage`` axis of
cards) becomes ``pipelined``: on one card the head runs through the
one-device GPipe schedule of ``parallel.pipeline.pipeline_apply``, which
calls every stage at each of its ``n_micro + n_stages - 1`` ticks (on
placeholder inputs during fill and drain), so the head makes
``(n_micro + n_stages - 1) * sp`` block calls on microbatches where the
sequential fallback makes ``sp`` on the whole batch. ``use_kernel`` and
the flash ``attn_fn`` are threaded through ``transformer.block_apply`` as
``transformer.forward`` does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import attn_fn as flash_attn_fn
from repro_torch.models import transformer
from repro_torch.models.layers import linear, rms_norm
from repro_torch.parallel.pipeline import pipeline_apply, split_microbatches
from repro_torch.tree import map_tree


@dataclasses.dataclass(frozen=True)
class HybridLMPlan:
    sp: int                 # blocks in the pipelined head
    n_stages: int           # pipeline stages (sp % n_stages == 0)
    n_micro: int            # microbatches

    @property
    def layers_per_stage(self) -> int:
        return self.sp // self.n_stages


def _split_head(params, plan: HybridLMPlan):
    """blocks (L, ...) -> head (n_stages, layers_per_stage, ...), tail (L - sp, ...)."""
    head = map_tree(lambda a: a[:plan.sp].reshape(
        (plan.n_stages, plan.layers_per_stage) + tuple(a.shape[1:])), params["blocks"])
    tail = map_tree(lambda a: a[plan.sp:], params["blocks"])
    return head, tail


def hybrid_lm_forward(params, cfg: ArchConfig, tokens: torch.Tensor, plan: HybridLMPlan, *,
                      pipelined: bool = False, compute_dtype=torch.bfloat16,
                      use_kernel: bool = True) -> torch.Tensor:
    """tokens (B, S) integer -> logits (B, S, vocab) in fp32, the first
    ``plan.sp`` blocks as a pipelined head (``pipelined=True``, sp > 0) or
    stage after stage (the reference's fallback without a mesh); the same
    arithmetic either way."""
    x = params["embed"][tokens].to(compute_dtype)
    head, tail = _split_head(params, plan)
    attn_fn = flash_attn_fn if use_kernel else None

    def blocks(stacked, n, h):
        for bp in transformer.unstack(stacked, n):
            h = transformer.block_apply(h, bp, cfg, attn_fn, use_kernel=use_kernel)
        return h

    def stage_fn(stage_params, h):
        return blocks(stage_params, plan.layers_per_stage, h)

    stages = [transformer.layer(head, i) for i in range(plan.n_stages)]
    if pipelined and plan.sp > 0:
        y = pipeline_apply(stage_fn, stages, split_microbatches(x, plan.n_micro))
        x = y.reshape((-1,) + tuple(y.shape[2:]))
    else:
        for sp in stages:
            x = stage_fn(sp, x)
    x = blocks(tail, cfg.n_layers - plan.sp, x)
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    return linear(x, transformer._head(params), use_kernel).float()


def hybrid_lm_loss(params, cfg: ArchConfig, tokens, labels, plan: HybridLMPlan, **kw):
    return transformer.softmax_xent(hybrid_lm_forward(params, cfg, tokens, plan, **kw), labels)
