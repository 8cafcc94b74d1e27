"""Hybrid execution plan for transformer LMs: the paper's paradigm applied
to the dense LM.

The counterpart of ``repro/train/hybrid.py``. The DSE's split point SP
sends the first SP decoder blocks through dedicated pipeline stages (the
paper's pipeline structure: microbatches streaming through the stages)
and the remaining blocks through the ordinary loop over blocks (the
generic, reusable structure). The head runs through
``parallel.pipeline.pipeline_apply``: over the ranks of a ``stage`` mesh
axis (``mesh=``, as the reference), rank ``i`` running stage ``i``'s
``plan.layers_per_stage`` blocks while the embedding, the tail, ``ln_f``
and the head run replicated on every rank; or on one device
(``pipelined=True``). Either way every stage is called at each of the
``n_micro + n_stages - 1`` ticks (on placeholder inputs during fill and
drain), so the head makes ``(n_micro + n_stages - 1) * layers_per_stage``
block calls a rank (times ``n_stages`` on one device) on microbatches where
the sequential fallback makes ``sp`` on the whole batch. ``use_kernel`` and
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
from repro_torch.parallel.collectives import axis_group
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


def hybrid_lm_forward(params, cfg: ArchConfig, tokens: torch.Tensor, plan: HybridLMPlan,
                      mesh=None, *, pipelined: bool = False, compute_dtype=torch.bfloat16,
                      use_kernel: bool = True) -> torch.Tensor:
    """tokens (B, S) integer -> logits (B, S, vocab) in fp32, the first
    ``plan.sp`` blocks as a pipelined head (sp > 0) over the ``stage`` axis
    of ``mesh`` (of size ``plan.n_stages``; rank ``i`` reads only stage
    ``i``'s head blocks) or on one device (``pipelined=True``), or stage
    after stage (the reference's fallback without a mesh); the same
    arithmetic either way."""
    if pipelined and mesh is not None:
        raise ValueError("pipelined=True runs the head on one device; a mesh spreads it "
                         "over ranks: pass one or the other")
    x = params["embed"][tokens].to(compute_dtype)
    head, tail = _split_head(params, plan)
    attn_fn = flash_attn_fn if use_kernel else None

    def blocks(stacked, n, h):
        for bp in transformer.unstack(stacked, n):
            h = transformer.block_apply(h, bp, cfg, attn_fn, use_kernel=use_kernel)
        return h

    def stage_fn(stage_params, h):
        return blocks(stage_params, plan.layers_per_stage, h)

    if mesh is not None and plan.sp > 0:
        _, n_stages, rank = axis_group(mesh, "stage")
        if n_stages != plan.n_stages:
            raise ValueError(f"the plan has {plan.n_stages} stages, the mesh's stage axis "
                             f"{n_stages} ranks")
        y = pipeline_apply(stage_fn, transformer.layer(head, rank),
                           split_microbatches(x, plan.n_micro), mesh, axis="stage")
        x = y.reshape((-1,) + tuple(y.shape[2:]))
    elif pipelined and plan.sp > 0:
        stages = [transformer.layer(head, i) for i in range(plan.n_stages)]
        y = pipeline_apply(stage_fn, stages, split_microbatches(x, plan.n_micro))
        x = y.reshape((-1,) + tuple(y.shape[2:]))
    else:
        for i in range(plan.n_stages):
            x = stage_fn(transformer.layer(head, i), x)
    # the generic tail, ln_f and the head, on every rank
    x = blocks(tail, cfg.n_layers - plan.sp, x)
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    return linear(x, transformer._head(params), use_kernel).float()


def hybrid_lm_loss(params, cfg: ArchConfig, tokens, labels, plan: HybridLMPlan, mesh=None,
                   **kw):
    return transformer.softmax_xent(hybrid_lm_forward(params, cfg, tokens, plan, mesh, **kw),
                                    labels)
