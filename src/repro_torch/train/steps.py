"""Step-function builders shared by the trainer and the server: the train
step (loss, grads, AdamW), the prefill step and the serve step (one-token
decode).

The counterpart of ``repro/train/steps.py``, on one card or on a
``DeviceMesh``. The reference jits each step with in/out shardings and
donates its params and state; here the steps run eagerly, and AdamW
updates the params and its state in place (``repro_torch.optim.adamw``).

On a mesh (``build_step(mesh=)``) every tensor is a DTensor: params and
the moments placed by ``sharding.param_pspecs``, the batch by
``batch_pspecs``, the cache by ``cache_pspecs`` (a plain tensor handed in,
the same global tensor on every rank, is sliced to this rank's shard; a
DTensor is moved to its spec's placements). The step runs with the
activation table of ``act.default_specs`` installed on that mesh, so the
models' ``constrain`` calls pin their activations, and with
``implicit_replication`` on, so that the plain tensors a model builds from
shapes (masks, RoPE tables) meet DTensors as replicated ones; a table the
caller installed takes the default's place (``on_mesh``). Prefill and
decode take the kernels on each rank's local shards; the train step takes
the plain route, as on one card. ``init_params_on_mesh`` draws the
one-card weights and keeps each rank's shards.

:class:`StepOptions` keeps the reference's knobs:

* ``remat`` — the activation-checkpoint policy of every block ("full",
  "dots", "none"; ``models.transformer.rematted``);
* ``cast_params`` — cast the fp32 master weights to bf16 once at step
  entry (the gradients flow back through the cast to the fp32 weights);
* ``constrain_grads`` — redistribute each gradient to its param's
  placements as soon as autograd returns it (the reduction over the data
  axes; ``adamw.apply`` does it otherwise). One card has no placements, so
  without a mesh it raises ``NotImplementedError`` rather than be ignored.
"""
from __future__ import annotations

import dataclasses

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve
from repro_torch.launch.specs import input_specs
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.parallel import act
from repro_torch.parallel import sharding as shd
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


def build_step(cfg: ArchConfig, shape: ShapeSpec, *, mesh=None, device="cuda",
               opts: StepOptions = BASELINE, ocfg: adamw.AdamWConfig | None = None,
               compute_dtype=torch.bfloat16):
    """The step of ``shape.kind`` as a function:

    * train: ``(params, opt_state, batch) -> (params, opt_state, loss,
      grad_norm)``, params and state updated in place (bf16 compute);
    * prefill: ``(params, batch) -> logits`` (the kernel route);
    * decode: ``(params, cache, tokens, pos) -> (logits, new cache)``.

    ``batch`` holds tensors on ``device``; the models compute in
    ``compute_dtype`` (the reference's default, bf16). With ``mesh`` (a ``DeviceMesh``
    with ``data`` and ``model`` axes, ``pod`` optional) the step is the
    sharded one of the module's docstring: it returns DTensors (loss and
    grad norm as plain 0-d tensors, the same on every rank), prefill's
    logits placed as ``(dp, None, "model")`` and decode's as
    ``(dp, "model")``, each fitted to the shape.
    """
    if mesh is not None:
        return _sharded_step(cfg, shape, mesh, opts, ocfg or adamw.AdamWConfig(), compute_dtype)
    resolve(device)
    if opts.constrain_grads:
        raise NotImplementedError("constrain_grads pins gradients to their params' placements; "
                                  "one card has none: pass a mesh (build_step(mesh=), ROADMAP.md "
                                  "queue 1 item 11)")

    if shape.kind == "train":
        ocfg = ocfg or adamw.AdamWConfig()

        def train_step(params, opt_state, batch):
            loss, grads = loss_and_grads(params, cfg, batch, cast_params=opts.cast_params,
                                         remat=opts.remat, compute_dtype=compute_dtype)
            params, opt_state, stats = adamw.apply(grads, opt_state, params, ocfg)
            return params, opt_state, loss, stats["grad_norm"]

        return train_step

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            p = cast_bf16(params) if opts.cast_params else params
            return api.prefill_logits(p, cfg, batch, remat="none", compute_dtype=compute_dtype)

        return prefill_step

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        p = cast_bf16(params) if opts.cast_params else params
        return api.decode_step(p, cfg, cache, tokens, pos, compute_dtype=compute_dtype)

    return serve_step


def init_params_on_mesh(cfg: ArchConfig, mesh, *, seed: int, dtype=torch.float32):
    """``api.init_params`` from ``torch.Generator(mesh.device_type)`` seeded
    with ``seed``, the one-card draw, as DTensors placed by
    ``sharding.param_pspecs``: each rank keeps only its shards. The ranks
    take turns, one whole draw on the device at a time, so that the card
    they may share holds one full tree at most."""
    out = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            gen = torch.Generator(device=mesh.device_type).manual_seed(seed)
            params = api.init_params(cfg, generator=gen, device=mesh.device_type, dtype=dtype)
            out = shd.distribute(params, shd.param_pspecs(params, mesh), mesh)
            del params
            if mesh.device_type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def constrained(grads, params):
    """Each DTensor gradient moved to its param's placements
    (``adamw.placed_like``)."""
    return map_tree(adamw.placed_like, grads, params)


def on_mesh(mesh):
    """The context a sharded step runs in: the activation table the caller
    installed (``act.activation_specs``; a hill-climb variant's), else
    ``act.default_specs(mesh)``, with ``_mesh`` (so ``constrain`` pins), and
    ``implicit_replication``. The reference's ``build_step`` traces under
    the ambient table the same way."""
    table = act.installed_specs()
    stack = contextlib.ExitStack()
    stack.enter_context(act.activation_specs(
        dict(act.default_specs(mesh) if table is None else table, _mesh=mesh)))
    stack.enter_context(implicit_replication())
    return stack


def _sharded_step(cfg: ArchConfig, shape: ShapeSpec, mesh, opts: StepOptions,
                  ocfg: adamw.AdamWConfig, compute_dtype):
    b_specs = shd.batch_pspecs(cfg, shape, input_specs(cfg, shape), mesh)
    dpa = shd.dp_spec(mesh)

    def place(tree, specs):
        return shd.distribute(tree, specs, mesh)

    def place_params(params):
        return place(params, shd.param_pspecs(params, mesh))

    def fitted(t, spec):
        return t.redistribute(mesh, shd.placements(shd.fit_spec(spec, tuple(t.shape), mesh), mesh))

    if shape.kind == "train":
        def train_step(params, opt_state, batch):
            p_specs = shd.param_pspecs(params, mesh)
            params = place(params, p_specs)
            opt_state = place(opt_state, shd.opt_pspecs(p_specs))
            batch = place(batch, {k: b_specs[k] for k in batch})
            with on_mesh(mesh):
                loss, grads = loss_and_grads(params, cfg, batch, cast_params=opts.cast_params,
                                             remat=opts.remat, compute_dtype=compute_dtype)
                if opts.constrain_grads:
                    grads = constrained(grads, params)
                params, opt_state, stats = adamw.apply(grads, opt_state, params, ocfg)
            return params, opt_state, loss.full_tensor(), stats["grad_norm"]

        return train_step

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            params = place_params(params)
            batch = place(batch, {k: b_specs[k] for k in batch})
            with on_mesh(mesh):
                p = cast_bf16(params) if opts.cast_params else params
                logits = api.prefill_logits(p, cfg, batch, remat="none",
                                            compute_dtype=compute_dtype)
            return fitted(logits, (dpa, None, "model"))

        return prefill_step

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        params = place_params(params)
        cache = place(cache, b_specs["cache"])
        tokens, pos = place(tokens, b_specs["tokens"]), place(pos, b_specs["pos"])
        with on_mesh(mesh):
            p = cast_bf16(params) if opts.cast_params else params
            logits, cache = api.decode_step(p, cfg, cache, tokens, pos,
                                            compute_dtype=compute_dtype)
        return fitted(logits, (dpa, "model")), place(cache, b_specs["cache"])

    return serve_step
