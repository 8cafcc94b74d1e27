"""Training loop: checkpoint/auto-resume, straggler monitoring, failure
injection (for tests) and retry-with-restore.

The counterpart of ``repro/train/trainer.py``, on one card (no mesh, the
default) or on a ``DeviceMesh`` with ``data`` and ``model`` axes:
* every batch is a pure function of (seed, step, shard)
  (``repro_torch.data.pipeline``), so nothing of the data loader needs
  restoring after a failure;
* checkpoints are atomic (``repro_torch.checkpoint.store``), in the JAX
  package's layout;
* a step slower than ``straggler_factor`` x the EWMA of step times is
  logged as a straggler;
* a failed step restores the last checkpoint and replays (bounded by
  ``max_restarts``).

The step is the reference's: ``api.loss_fn`` (the plain route, which
autograd differentiates) and its gradients, optionally int8-compressed
with zero error feedback (``compress_grads``, as the reference calls it on
the already-reduced gradients), then AdamW, in place.

On a mesh every rank of the default group runs the Trainer: params and the
AdamW moments are DTensors placed by ``sharding.param_pspecs`` (drawn by
``steps.init_params_on_mesh``, the one-card values), each batch is the
global batch sliced over the data axes, the step runs as
``build_step(mesh=)``'s does (``steps.on_mesh``), each gradient is brought
to its param's placements before compression, and checkpoints hold the
global arrays, so a run restores onto a mesh of another shape.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.collectives import compress_grads, init_error_feedback
from .steps import constrained, init_params_on_mesh, loss_and_grads, on_mesh

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    ewma: float = 0.9
    max_restarts: int = 3
    remat: str = "full"
    compute_dtype: str = "bfloat16"
    grad_compression: bool = False


class Trainer:
    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, tcfg: TrainConfig, *, mesh=None,
                 ocfg: adamw.AdamWConfig | None = None, device="cuda"):
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        self.ocfg = ocfg or adamw.AdamWConfig(total_steps=tcfg.steps)
        self.mesh = mesh
        self.device = resolve(device if mesh is None else mesh.device_type)
        self.data = TokenPipeline(DataConfig(
            vocab=cfg.vocab, seq_len=shape.seq_len,
            global_batch=shape.global_batch, seed=tcfg.seed))
        self.compute_dtype = (torch.bfloat16 if tcfg.compute_dtype == "bfloat16"
                              else torch.float32)
        self.step = 0
        self.stats: list[dict] = []
        self.straggler_events: list[int] = []
        self._fail_at: set[int] = set()  # test hook
        self._restarts = 0

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state, batch):
        if self.mesh is None:
            return self._step(params, opt_state, batch)
        with on_mesh(self.mesh):
            params, opt_state, loss, gnorm = self._step(params, opt_state, batch)
        return params, opt_state, loss.full_tensor(), gnorm

    def _step(self, params, opt_state, batch):
        loss, grads = loss_and_grads(params, self.cfg, batch, remat=self.tcfg.remat,
                                     compute_dtype=self.compute_dtype)
        if self.mesh is not None:
            grads = constrained(grads, params)
        if self.tcfg.grad_compression:
            grads, _ = compress_grads(grads, init_error_feedback(grads))
        params, opt_state, st = adamw.apply(grads, opt_state, params, self.ocfg)
        return params, opt_state, loss, st["grad_norm"]

    def init_state(self):
        if self.mesh is not None:
            params = init_params_on_mesh(self.cfg, self.mesh, seed=self.tcfg.seed)
            return params, adamw.init(params)
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = api.init_params(self.cfg, generator=gen, device=self.device)
        return params, adamw.init(params)

    def placements(self, params):
        """(mesh, placements) of the params' and the state's leaves, for
        ``store.restore``; None without a mesh."""
        if self.mesh is None:
            return None
        p_specs = shd.param_pspecs(params, self.mesh)
        return shd.shardings({"params": p_specs, "opt": shd.opt_pspecs(p_specs)}, self.mesh)

    def restore_or_init(self):
        last = store.latest_step(self.tcfg.ckpt_dir)
        params, opt = self.init_state()
        if last is not None:
            log.info("resuming from checkpoint step %d", last)
            tree = store.restore(self.tcfg.ckpt_dir, last, {"params": params, "opt": opt},
                                 placements=self.placements(params))
            params, opt = tree["params"], tree["opt"]
            self.step = last
        return params, opt

    def _make_batch(self, step: int) -> dict:
        b = self.data.make(step)
        batch = {k: torch.from_numpy(v).to(self.device, torch.int64) for k, v in b.items()}
        if self.mesh is None:
            return batch
        dp = shd.dp_spec(self.mesh)
        specs = {k: shd.fit_spec((dp, None), tuple(v.shape), self.mesh) for k, v in batch.items()}
        return shd.distribute(batch, specs, self.mesh)

    # ------------------------------------------------------------------
    def fail_at(self, *steps: int):
        """Test hook: inject a simulated node failure at given steps."""
        self._fail_at.update(steps)

    def run(self):
        params, opt = self.restore_or_init()
        ewma_t = None
        while self.step < self.tcfg.steps:
            s = self.step
            t0 = time.perf_counter()
            try:
                if s in self._fail_at:
                    self._fail_at.discard(s)
                    raise RuntimeError(f"injected node failure @ step {s}")
                batch = self._make_batch(s)
                params, opt, loss, gnorm = self.train_step(params, opt, batch)
                loss = float(loss)
            except Exception as e:  # noqa: BLE001 — failover path
                self._restarts += 1
                if self._restarts > self.tcfg.max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring last checkpoint", s, e)
                params, opt = self.restore_or_init()
                continue

            dt = time.perf_counter() - t0
            ewma_t = dt if ewma_t is None else (
                self.tcfg.ewma * ewma_t + (1 - self.tcfg.ewma) * dt)
            if dt > self.tcfg.straggler_factor * ewma_t and s > 2:
                self.straggler_events.append(s)
                log.warning("straggler: step %d took %.2fs (ewma %.2fs)", s, dt, ewma_t)

            self.step = s + 1
            self.stats.append({"step": s, "loss": loss,
                               "grad_norm": float(gnorm), "time_s": dt})
            if s % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f gnorm %.3f %.2fs", s, loss, float(gnorm), dt)
            if self.step % self.tcfg.ckpt_every == 0 or self.step == self.tcfg.steps:
                store.save(self.tcfg.ckpt_dir, self.step, {"params": params, "opt": opt},
                           meta={"arch": self.cfg.name, "loss": loss})
        return params, opt


# convenience for checkpoints saved by Trainer (params+opt under one tree)
def restore_trainer_state(trainer: Trainer, step: int):
    params, opt = trainer.init_state()
    tree = store.restore(trainer.tcfg.ckpt_dir, step, {"params": params, "opt": opt},
                         placements=trainer.placements(params))
    return tree["params"], tree["opt"]
