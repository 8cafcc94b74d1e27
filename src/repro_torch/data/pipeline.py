"""Deterministic, stateless synthetic token pipeline.

A line-for-line copy of ``repro/data/pipeline.py`` (NumPy), kept here so
that the port imports nothing of ``repro``; ``tests/test_torch_train.py``
checks that both copies give the same batches.

Every batch is a pure function of (seed, step, shard) — the property the
fault-tolerance story relies on: after a node failure ANY host can
recompute ANY shard for ANY step with no pipeline state to restore, and
elastic rescaling just changes the (shard, n_shards) factorization.
Tokens follow a Zipfian unigram draw with a repeated-ngram structure so
the LM loss actually decreases during the example runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_count: int = 64


class TokenPipeline:
    """make(step, shard, n_shards) -> {"tokens", "labels"} numpy arrays."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        # fixed motif table: repeated n-grams give the model learnable signal
        ranks = base.zipf(cfg.zipf_a, size=(cfg.motif_count, cfg.motif_len))
        self._motifs = (ranks % (cfg.vocab - 1)).astype(np.int32)

    def batch_shape(self, n_shards: int) -> tuple[int, int]:
        assert self.cfg.global_batch % n_shards == 0
        return (self.cfg.global_batch // n_shards, self.cfg.seq_len)

    def make(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        cfg = self.cfg
        bs, sl = self.batch_shape(n_shards)
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard, n_shards]))
        ranks = rng.zipf(cfg.zipf_a, size=(bs, sl + 1))
        toks = (ranks % (cfg.vocab - 1)).astype(np.int32)
        # plant motifs at random offsets (learnable structure)
        n_plant = max(1, sl // (4 * cfg.motif_len))
        for b in range(bs):
            ids = rng.integers(0, cfg.motif_count, n_plant)
            offs = rng.integers(0, sl + 1 - cfg.motif_len, n_plant)
            for m, o in zip(ids, offs):
                toks[b, o:o + cfg.motif_len] = self._motifs[m]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
