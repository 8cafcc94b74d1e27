"""Offline batched prefill: every step is one ``api.prefill_logits`` over a
batch of ``tokens_per_batch`` prompt tokens, the sequence length cycling
through ``seq_lens`` in a fixed order (batch = tokens_per_batch / S), the
next-token choices of every position brought back to the host (what a
scorer or indexer consumes). The seed draws the token ids only, so every
seed runs the same shapes; a window ends at the end of a cycle.

Traffic keys: ``seq_lens``, ``tokens_per_batch``, ``pool`` (distinct
batches drawn per length, used in turn), ``trace_steps``, ``judge`` (rows
judged of each length, drawn from the seed among the window's batches).
"""
from __future__ import annotations

import time

import torch

from portbench.harness.judge import Judged


def setup(run) -> dict:
    from repro_torch.models import api  # the program: imported by the driver alone
    tr = run.traffic
    shapes = [(tr["tokens_per_batch"] // s, s) for s in tr["seq_lens"]]
    pool = [torch.randint(0, run.arch["vocab"], (tr["pool"], b, s), generator=run.gen,
                          device=run.device) for b, s in shapes]
    state = {"api": api, "shapes": shapes, "pool": pool, "i": 0, "preds": []}
    for k in range(len(shapes)):  # warm every shape of the cycle once
        _forward(run, state, k, 0)
    state["i"] = 0
    return state


def cycle(state) -> int:
    return len(state["shapes"])


def _forward(run, state, k: int, j: int) -> torch.Tensor:
    with torch.inference_mode():
        logits = state["api"].prefill_logits(run.weights, run.program_cfg,
                                             {"tokens": state["pool"][k][j]})
        return logits.argmax(-1).cpu()


def step(run, state) -> dict:
    i = state["i"]
    n = len(state["shapes"])
    k, j = i % n, (i // n) % run.traffic["pool"]
    t0 = time.perf_counter()
    pred = _forward(run, state, k, j)
    t1 = time.perf_counter()
    b, s = state["shapes"][k]
    state["preds"].append((k, j, pred))
    state["i"] = i + 1
    return {"t0": t0, "t1": t1, "b": b, "s": s, "tokens": b * s}


def judged(run, state) -> list[Judged]:
    """Rows drawn from the seed without replacement: ``judge[k]`` of the k-th
    length among the rows of the batches the steps ran (the longest length
    included)."""
    out = []
    for k, (b, s) in enumerate(state["shapes"]):
        ran = [(j, pred) for kk, j, pred in state["preds"] if kk == k]
        n = min(run.traffic["judge"][k], len(ran) * b)
        for i in sorted(run.rng.choice(len(ran) * b, n, replace=False)):
            (j, pred), row = ran[i // b], int(i % b)
            out.append(Judged(tokens=state["pool"][k][j, row],
                              positions=torch.arange(s, device=run.device),
                              served=pred[row].to(run.device)))
    return out


def attempted(run, state) -> int:
    """Sequences the window scored."""
    return sum(r["b"] for r in run.steps)


def counters(state) -> dict:
    return {}


def close(state) -> None:
    state.clear()
