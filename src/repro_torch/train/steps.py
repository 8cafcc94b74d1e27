"""Step-function builders shared by the trainer and the server: the train
step (loss, grads, AdamW), the prefill step and the serve step (one-token
decode).

The counterpart of ``repro/train/steps.py`` on one card. The reference
jits each step with in/out shardings and donates its params and state;
neither has a counterpart here: the steps run eagerly, and AdamW updates
the params and its state in place (``repro_torch.optim.adamw``).
:class:`StepOptions` keeps the reference's knobs:

* ``remat`` — the activation-checkpoint policy of every block ("full",
  "dots", "none"; ``models.transformer.rematted``);
* ``cast_params`` — cast the fp32 master weights to bf16 once at step
  entry (the gradients flow back through the cast to the fp32 weights);
* ``constrain_grads`` — pin the gradients' shardings to the params'. One
  card has no shardings, so it raises ``NotImplementedError`` rather than
  be ignored: it waits for the sharded train step (``build_step`` on a
  mesh, ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.tree import flatten, map_tree, map_with_path


@dataclasses.dataclass(frozen=True)
class StepOptions:
    remat: str = "full"          # full | dots | none
    cast_params: bool = False    # bf16 cast at step entry
    constrain_grads: bool = False  # grad shardings pinned to the params' (many cards)


BASELINE = StepOptions()
OPTIMIZED = StepOptions(remat="dots", cast_params=True, constrain_grads=True)


def cast_bf16(params):
    return map_tree(lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p, params)


def loss_and_grads(params, cfg: ArchConfig, batch: dict, *, cast_params: bool = False, **kw):
    """(loss, grads): ``api.loss_fn`` and its gradient with respect to every
    leaf of ``params`` (a tree of their shapes and dtypes). ``params`` are
    not marked as requiring grad: the loss is taken of detached aliases."""
    leaf = map_tree(lambda p: p.detach().requires_grad_(), params)
    loss = api.loss_fn(cast_bf16(leaf) if cast_params else leaf, cfg, batch, **kw)
    keys, tensors = zip(*flatten(leaf))
    by_key = dict(zip(keys, torch.autograd.grad(loss, tensors)))
    return loss.detach(), map_with_path(lambda key, _: by_key[key], leaf)


def build_step(cfg: ArchConfig, shape: ShapeSpec, *, device="cuda",
               opts: StepOptions = BASELINE, ocfg: adamw.AdamWConfig | None = None):
    """The step of ``shape.kind`` as a function:

    * train: ``(params, opt_state, batch) -> (params, opt_state, loss,
      grad_norm)``, params and state updated in place (bf16 compute);
    * prefill: ``(params, batch) -> logits`` (the kernel route);
    * decode: ``(params, cache, tokens, pos) -> (logits, new cache)``.

    ``batch`` holds tensors on ``device``.
    """
    resolve(device)
    if opts.constrain_grads:
        raise NotImplementedError("constrain_grads pins gradient shardings across cards; one "
                                  "card has none (ROADMAP.md queue 1 item 11)")

    if shape.kind == "train":
        ocfg = ocfg or adamw.AdamWConfig()

        def train_step(params, opt_state, batch):
            loss, grads = loss_and_grads(params, cfg, batch, cast_params=opts.cast_params,
                                         remat=opts.remat)
            params, opt_state, stats = adamw.apply(grads, opt_state, params, ocfg)
            return params, opt_state, loss, stats["grad_norm"]

        return train_step

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            p = cast_bf16(params) if opts.cast_params else params
            return api.prefill_logits(p, cfg, batch, remat="none")

        return prefill_step

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        p = cast_bf16(params) if opts.cast_params else params
        return api.decode_step(p, cfg, cache, tokens, pos)

    return serve_step
