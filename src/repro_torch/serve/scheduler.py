"""Continuous-batching serving scheduler.

The counterpart of ``repro/serve/scheduler.py``: requests arrive with
prompts of different lengths; the scheduler admits them into a fixed pool
of sequence slots, teacher-forces prompts (prefill by decode, one step
function), emits tokens until EOS or ``max_new``, and backfills freed slots
from the queue. Admission, commit, EOS, ``steps`` and ``utilization``
follow the reference line for line, except that an admitted slot's
recurrent state starts again from its initial value (``reset_slot``
copies it from a one-slot ``api.init_cache``: the hybrid family's conv and
SSM lines at zero; xLSTM's mLSTM C and n at zero and its stabiliser m at
-1e30, its sLSTM h and c at zero), which the reference omits; the decode
step is ``repro_torch.models.api.decode_step`` under
``torch.inference_mode()``, through the kernels unless ``use_kernel=False``,
with the batcher's cache donated (``donate=True``): the dense and VLM
families update it in place.

Every tick is recorded in the batcher's ``spans`` (an in-memory
``repro_torch.obs.hotpath.SpanRing``, always on: a few microseconds a tick)
as a ``serve.tick`` span with attrs ``tick`` (``steps`` after it), ``busy``
(occupied slots) and ``generated`` (slots that emitted a token), holding
``serve.admit`` (attr ``rids``, the requests admitted), ``serve.gather``,
``serve.decode`` (until ``decode_step`` returns: the enqueue),
``serve.sync`` (``argmax(...).cpu()``, the tick's one wait on the device)
and ``serve.commit`` (the host loop after it). A call that finds no work
records a ``serve.tick`` holding ``serve.admit`` alone, with no attrs.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.obs.hotpath import SpanRing
from repro_torch.tree import flatten, leaves


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    eos: int | None = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list[int]
    prompt_len: int
    steps_in_flight: int


# KV lines: positions at or past a slot's ``pos`` are masked, so a reused
# slot needs them not wiped.
_POSITIONAL = ("k", "v")


def reset_slot(cache, fresh, slot: int) -> None:
    """Copy ``fresh``, the family's cache of one sequence as
    ``api.init_cache`` builds it, into slot ``slot`` of ``cache``, leaf by
    leaf, in place, but for the KV lines: the slot's recurrent state starts
    again from its initial value (xLSTM's m at -1e30, the rest at zero). A
    leaf's slot axis is the first whose length differs from the one-slot
    leaf's."""
    for (path, t), f in zip(flatten(cache), leaves(fresh)):
        if path.rsplit("/", 1)[-1] in _POSITIONAL:
            continue
        axis = next((a for a, (n, m) in enumerate(zip(t.shape, f.shape)) if n != m), None)
        (t if axis is None else t.narrow(axis, slot, 1)).copy_(f)


class ContinuousBatcher:
    """Fixed-slot continuous batching over api.decode_step."""

    # spans kept: 6 a tick, so ~10,900 ticks, the last 12 minutes at a 70 ms tick
    SPANS = 1 << 16

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4, max_seq: int = 256,
                 greedy: bool = True, device="cuda", use_kernel: bool = True):
        self.cfg, self.params = cfg, params
        self.slots, self.max_seq = slots, max_seq
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        if cfg.family == "audio":
            raise NotImplementedError(
                "the batcher's requests carry no audio frames, so the cross-attention K/V "
                "of a slot would never be filled; serve the audio family with "
                "encdec.prefill_cross and api.decode_step")
        self.cache = api.init_cache(cfg, slots, max_seq, device=self.device)
        self.fresh = api.init_cache(cfg, 1, max_seq, device=self.device)
        # per-slot state (host-side bookkeeping)
        self.active: list[dict | None] = [None] * slots
        self.queue: deque[Request] = deque()
        self.done: list[Completion] = []
        self.steps = 0
        self.busy_slot_steps = 0
        self.spans = SpanRing(self.SPANS, proc="batcher")

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self) -> list[int]:
        rids = []
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = {"req": req, "pos": 0, "out": [],
                                  "start_step": self.steps}
                # KV positions >= pos are masked by valid_upto, so the KV
                # cache needs no wipe; the recurrent states are not
                # positional, so the slot's start again from their initial
                # values. (The reference resets none and so starts a request
                # from the previous one's state: ROADMAP.md queue 3, fault 4.)
                with torch.inference_mode():
                    reset_slot(self.cache, self.fresh, s)
                rids.append(req.rid)
        return rids

    def _gather_inputs(self):
        toks = np.zeros((self.slots, 1), np.int64)
        pos = np.zeros((self.slots,), np.int64)
        for s, st in enumerate(self.active):
            if st is None:
                continue
            req, p = st["req"], st["pos"]
            if p < len(req.prompt):
                toks[s, 0] = req.prompt[p]          # teacher-forced prefill
            else:
                toks[s, 0] = st["out"][-1] if st["out"] else 0
            pos[s] = p
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(pos).to(self.device))

    def _decode(self, toks, pos):
        # the batcher owns its cache and rebinds it every tick, so it donates
        # it: the dense and VLM steps write the tick's K/V in place
        with torch.inference_mode():
            return api.decode_step(self.params, self.cfg, self.cache, toks, pos,
                                   use_kernel=self.use_kernel, donate=True)

    def _commit(self, nxt) -> int:
        """Advance every occupied slot by the tick whose next tokens are
        ``nxt`` (on the host); returns the number of tokens emitted."""
        generated = 0
        for s, st in enumerate(self.active):
            if st is None:
                continue
            req = st["req"]
            st["pos"] += 1
            in_prefill = st["pos"] < len(req.prompt)
            if not in_prefill:
                tok = int(nxt[s])
                st["out"].append(tok)
                generated += 1
                finished = (len(st["out"]) >= req.max_new
                            or (req.eos is not None and tok == req.eos)
                            or st["pos"] >= self.max_seq - 1)
                if finished:
                    self.done.append(Completion(
                        req.rid, st["out"], len(req.prompt),
                        self.steps - st["start_step"] + 1))
                    self.active[s] = None
        return generated

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One decode tick for every occupied slot. Returns False when
        idle (no active work and empty queue)."""
        span = self.spans.span
        with span("serve.tick") as tick:
            with span("serve.admit") as admit:
                admit.attrs["rids"] = self._admit()
            if all(st is None for st in self.active):
                return False
            with span("serve.gather"):
                toks, pos = self._gather_inputs()
            with span("serve.decode"):
                logits, self.cache = self._decode(toks, pos)
            busy = sum(st is not None for st in self.active)
            self.busy_slot_steps += busy
            self.steps += 1
            with span("serve.sync"):
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            with span("serve.commit"):
                generated = self._commit(nxt)
            tick.attrs.update(tick=self.steps, busy=busy, generated=generated)
        return True

    def run(self, max_steps: int = 10_000) -> list[Completion]:
        while self.step() and self.steps < max_steps:
            pass
        return self.done

    @property
    def utilization(self) -> float:
        """Occupied-slot fraction over the run — what continuous batching
        optimizes vs static batching."""
        return self.busy_slot_steps / max(self.steps * self.slots, 1)
