"""Serving under a closed loop: ``clients`` clients, each submitting its
next request to a ``ContinuousBatcher`` of ``slots`` slots and ``max_seq``
positions as soon as its last one completes. A step is one
``ContinuousBatcher.step()``, which teacher-forces prompts one token a tick
and generates greedily (no EOS) until ``max_new``.

Sizes: prompt and output lengths are log-uniform on ``prompt`` and
``output`` ([lo, hi]), a pair drawn again while their sum passes
``max_total``; they come from the fixed ``size_seed``, so every run offers
the same sequence of sizes, and the run's seed draws the token ids.

The window opens on the loop's steady state. The first ``clients``
requests stand for those in flight: each is drawn with a chance in
proportion to its ticks (a slot observed at a random time holds a long
request more often than a short one) and has served a uniform share of its
ticks when the window opens. Set-up serves that share through the batcher
itself: request c is submitted at the set-up tick that leaves it ``age[c]``
ticks before the window, so its cache holds every position it would hold.
Set-up runs at most ``warmup_ticks`` ticks; an age above that is cut to it.

The driver keeps its own account of each request from the batcher's
documented schedule (admitted at the tick after submission while a slot is
free; prompt token p fed at tick admit + p; the outputs at the last
``max_new`` ticks), checks it against every completion, and from it takes
the ticks at which each request's tokens reached the host.

Traffic keys: ``slots``, ``clients``, ``max_seq``, ``prompt``, ``output``,
``max_total``, ``size_seed``, ``stream`` (requests drawn), ``warmup_ticks``,
``trace_steps``, ``judge`` (completed requests judged: the longest and the
rest drawn from the seed).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from portbench.harness.judge import Judged


@dataclasses.dataclass
class Req:
    rid: int
    prompt: list
    max_new: int
    admit: int = 0          # 1-based tick of its first step
    done_tick: int = 0      # 1-based tick of its last output (0: in flight)
    out: list | None = None

    @property
    def ticks(self) -> int:
        return len(self.prompt) - 1 + self.max_new

    @property
    def first_out_tick(self) -> int:
        return self.admit + len(self.prompt) - 1

    @property
    def end_tick(self) -> int:
        return self.admit + self.ticks - 1


def _log_uniform(rng, lo: int, hi: int, n: int) -> np.ndarray:
    return np.floor(np.exp(rng.uniform(math.log(lo), math.log(hi + 1), n))).astype(int)


def _pairs(rng, tr: dict, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` (prompt, output) pairs of the mix, each drawn again while its sum
    passes ``max_total``."""
    p, o = np.zeros(0, int), np.zeros(0, int)
    while len(p) < n:
        pp = _log_uniform(rng, *tr["prompt"], 2 * n)
        oo = _log_uniform(rng, *tr["output"], 2 * n)
        keep = pp + oo <= tr["max_total"]
        p, o = np.concatenate([p, pp[keep]]), np.concatenate([o, oo[keep]])
    return p[:n], o[:n]


def sizes(tr: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(prompt lengths, output lengths, ages) of the request stream. The
    first ``clients`` are the in-flight first wave, drawn in proportion to
    their ticks from a pool of the mix, each with the ticks it has served
    when the window opens (``ages``, cut to ``warmup_ticks``)."""
    rng = np.random.default_rng(tr["size_seed"])
    c = tr["clients"]
    pool_p, pool_o = _pairs(rng, tr, 64 * c)
    ticks = pool_p - 1 + pool_o
    # stratified: one draw from each c-th of the ticks-weighted pool, and each
    # request's share of its ticks from each c-th of [0, 1), in a shuffled order
    order = np.argsort(ticks, kind="stable")
    cum = np.cumsum(ticks[order]) / ticks.sum()
    pick = order[np.searchsorted(cum, (np.arange(c) + rng.uniform(0.0, 1.0, c)) / c)]
    share = (rng.permutation(c) + rng.uniform(0.0, 1.0, c)) / c
    ages = np.minimum(np.floor(share * ticks[pick]).astype(int), tr["warmup_ticks"])
    p, o = _pairs(rng, tr, tr["stream"] - c)
    return np.concatenate([pool_p[pick], p]), np.concatenate([pool_o[pick], o]), ages


def setup(run) -> dict:
    from repro_torch.serve.scheduler import ContinuousBatcher, Request
    tr = run.traffic
    if tr["clients"] > tr["slots"]:
        raise ValueError("a closed loop with more clients than slots queues requests")
    p, o, ages = sizes(tr)
    if int((p + o).max()) > tr["max_seq"]:
        raise ValueError("a request of the stream passes max_seq")
    ids = run.rng.integers(0, run.arch["vocab"], (len(p), int(p.max())))
    reqs = [Req(i, [int(t) for t in ids[i, :p[i]]], int(o[i])) for i in range(len(p))]
    batcher = ContinuousBatcher(run.program_cfg, run.weights, slots=tr["slots"],
                                max_seq=tr["max_seq"], device=run.device)
    warmup = int(ages.max())
    if warmup < 2:
        raise ValueError("set-up needs two ticks at least: raise the first wave's ages")
    state = {"Request": Request, "batcher": batcher, "reqs": reqs, "next": len(ages),
             "live": {}, "tick_end": {}, "seen": 0, "warmup": warmup}
    # request c is admitted at set-up tick warmup + 1 - ages[c], so that the window's
    # first tick (warmup + 1) feeds its position ages[c]
    for t in range(1, warmup + 1):
        for c in np.flatnonzero(warmup + 1 - ages == t):
            _submit(state, reqs[c])
        step(run, state)
    return state


def _submit(state, r: Req | None = None) -> None:
    """Submit ``r``, or else the stream's next request."""
    if r is None:
        if state["next"] >= len(state["reqs"]):
            raise RuntimeError("the request stream ran out; raise the traffic's stream")
        r = state["reqs"][state["next"]]
        state["next"] += 1
    r.admit = state["batcher"].steps + 1
    state["live"][r.rid] = r
    state["batcher"].submit(state["Request"](rid=r.rid, prompt=r.prompt, max_new=r.max_new))


def cycle(state) -> int:
    return 1


def step(run, state) -> dict:
    b = state["batcher"]
    busy0, steps0 = b.busy_slot_steps, b.steps
    tick = b.steps + 1
    live = list(state["live"].values())
    positions = [tick - r.admit for r in live]
    out = sum(1 for r in live if r.first_out_tick <= tick)
    t0 = time.perf_counter()
    if not b.step():
        raise RuntimeError("the batcher went idle under a closed loop")
    t1 = time.perf_counter()
    if b.steps != steps0 + 1:
        raise RuntimeError(f"one step advanced the batcher by {b.steps - steps0} ticks")
    state["tick_end"][tick] = t1
    for c in b.done[state["seen"]:]:
        r = state["live"].pop(c.rid)
        if tick != r.end_tick or len(c.tokens) != r.max_new or c.prompt_len != len(r.prompt):
            raise RuntimeError(
                f"request {c.rid} left the batcher's documented schedule: done at tick {tick}, "
                f"expected {r.end_tick}; {len(c.tokens)} tokens of {r.max_new}")
        r.done_tick, r.out = tick, list(c.tokens)
        _submit(state)
    state["seen"] = len(b.done)
    return {"t0": t0, "t1": t1, "tick": tick, "active": len(live), "out": out,
            "positions": positions, "busy": b.busy_slot_steps - busy0}


def itl_gaps_s(run, state, first_tick: int, last_tick: int) -> list[float]:
    """The gaps between successive output tokens of every request, as the
    host received them, where both tokens arrived in ticks first..last."""
    ends = state["tick_end"]
    gaps = []
    for r in state["reqs"][: state["next"]]:
        lo = max(r.first_out_tick, first_tick)
        hi = min(r.end_tick, last_tick)
        gaps.extend(ends[k] - ends[k - 1] for k in range(lo + 1, hi + 1))
    return gaps


def judged(run, state) -> list[Judged]:
    """Completed requests: the longest, and the rest drawn from the seed."""
    done = [r for r in state["reqs"][: state["next"]] if r.out is not None
            and r.done_tick > state["warmup"]]
    if not done:
        raise RuntimeError("no request completed in the window")
    longest = max(done, key=lambda r: (len(r.prompt) + r.max_new, r.rid))
    rest = [r for r in done if r is not longest]
    k = min(len(rest), run.traffic["judge"] - 1)
    pick = [longest] + [rest[i] for i in sorted(run.rng.choice(len(rest), k, replace=False))]
    out = []
    for r in pick:
        seq = torch.tensor(r.prompt + r.out[:-1], device=run.device)
        p = len(r.prompt)
        out.append(Judged(tokens=seq, positions=torch.arange(p - 1, p - 1 + r.max_new,
                                                             device=run.device),
                          served=torch.tensor(r.out, device=run.device)))
    return out


def attempted(run, state) -> int:
    """Requests that the window served a tick of."""
    first, last = run.steps[0]["tick"], run.steps[-1]["tick"]
    return sum(1 for r in state["reqs"][: state["next"]]
               if r.admit <= last and r.end_tick >= first)


def counters(state) -> dict:
    b = state["batcher"]
    return {"steps": b.steps, "busy_slot_steps": b.busy_slot_steps, "slots": b.slots}


def close(state) -> None:
    state.clear()
