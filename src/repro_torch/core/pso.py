"""Global optimization: particle-swarm search over the RAV (Algorithm 1).

Each particle is a 5-dim position [SP, Batch, dsp_frac, bram_frac, bw_frac];
fitness is the (scalarized) objective returned by the local optimizers
(:func:`repro.core.local_opt.evaluate_rav`). Early termination fires when the
global best fails to improve for ``patience`` consecutive iterations (the
paper uses 2).

The swarm is one engine behind the ask/tell :class:`~repro.core.search.Searcher`
protocol: :class:`PSOSearcher` keeps the algorithm state (positions,
velocities, bests) and :func:`repro.core.search.run_search` owns the
shared bookkeeping — the rounded-RAV memo, budget accounting, result
assembly. The update loop is vectorized: per iteration the whole
population is pushed through one *batched* fitness call and
personal/global bests are refreshed with NumPy where/argmax.
:func:`repro.core.explore` hands in a hook backed by the batched
array-kernel engine (:mod:`repro.core.batch_eval`), so the math under
the hook is batched too; callers that only have a scalar ``fitness_fn``
get the same semantics (the batch is evaluated element-wise).

Trajectories are bit-identical to the pre-protocol loop under a fixed
seed — the RNG draw order (init positions, velocities, then r1/r2 per
iteration) is pinned by the golden-trajectory fixture in
``tests/test_search.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .local_opt import RAV
from .search import (SearchResult, Searcher, SearchSpace, register_searcher,
                     run_search)

#: Historical name: every engine now returns this shared result type.
PSOResult = SearchResult


def _clip(pos: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return np.clip(pos, lo, hi)


def _to_rav(pos: np.ndarray) -> RAV:
    return RAV(sp=int(round(pos[0])), batch=max(1, int(round(pos[1]))),
               dsp_frac=float(pos[2]), bram_frac=float(pos[3]),
               bw_frac=float(pos[4]))


@dataclasses.dataclass
class PSOConfig:
    population: int = 24
    iterations: int = 40
    inertia: float = 0.729       # w
    c_local: float = 1.494       # c1
    c_global: float = 1.494      # c2
    patience: int = 2            # early-termination window (paper Sec. 7.2)
    seed: int = 0

    def eval_cap(self) -> int:
        return self.population * (self.iterations + 1)


class PSOSearcher(Searcher):
    """Algorithm 1 as an ask/tell engine. ``init_positions`` overrides
    the canonical seed particles (rows 0..n-1) — the hook hyperband's
    refinement stage uses to start the swarm at its screen survivors;
    the default path plants the canonical three exactly as the
    pre-protocol loop did."""

    name = "pso"

    def __init__(self, space: SearchSpace, cfg: PSOConfig,
                 init_positions: np.ndarray | None = None):
        super().__init__(space, cfg)
        rng = np.random.default_rng(cfg.seed)
        self._rng = rng
        self._lo, self._hi = space.lo(), space.hi()
        pos = rng.uniform(self._lo, self._hi, size=(cfg.population, 5))
        if init_positions is None:
            pos[:3] = space.canonical()
        else:
            n = min(len(init_positions), cfg.population)
            pos[:n] = init_positions[:n]
        self._pos = pos
        self._vel = rng.uniform(-1, 1, size=(cfg.population, 5)) \
            * (self._hi - self._lo) * 0.1
        self._pbest = None
        self._pbest_fit = None
        self._stale = 0

    def ask(self) -> np.ndarray | None:
        if self.done:
            return None
        if self._pbest is None:      # initial population
            return self._pos
        cfg = self.cfg
        r1 = self._rng.random((cfg.population, 5))
        r2 = self._rng.random((cfg.population, 5))
        self._vel = (cfg.inertia * self._vel
                     + cfg.c_local * r1 * (self._pbest - self._pos)
                     + cfg.c_global * r2 * (self.best_pos[None, :] - self._pos))
        self._pos = np.clip(self._pos + self._vel, self._lo, self._hi)
        return self._pos

    def tell(self, fits: np.ndarray) -> None:
        if self._pbest is None:      # init round
            self._pbest = self._pos.copy()
            self._pbest_fit = fits
            g = int(np.argmax(fits))
            self.best_pos = self._pbest[g].copy()
            self.best_fit = float(fits[g])
            self.history = [self.best_fit]
            if self.cfg.iterations <= 0:
                self.done = True
            return
        better = fits > self._pbest_fit
        self._pbest = np.where(better[:, None], self._pos, self._pbest)
        self._pbest_fit = np.where(better, fits, self._pbest_fit)
        best_i = int(np.argmax(fits))
        improved = bool(fits[best_i] > self.best_fit)
        if improved:
            self.best_pos = self._pos[best_i].copy()
            self.best_fit = float(fits[best_i])
        self.iterations_run += 1
        self.history.append(self.best_fit)
        self._stale = 0 if improved else self._stale + 1
        if self._stale >= self.cfg.patience:
            self.stop_reason = "converged"
            self.done = True
        elif self.iterations_run >= self.cfg.iterations:
            self.done = True


register_searcher("pso", PSOSearcher, PSOConfig)


def optimize(fitness_fn: Callable[[RAV], float] | None = None, *,
             sp_max: int, batch_max: int = 1,
             cfg: PSOConfig | None = None,
             batch_fitness_fn: Callable[[Sequence[RAV]], Sequence[float]] | None = None,
             ) -> PSOResult:
    """Algorithm 1. Fitness must be deterministic (results are memoized on the
    rounded RAV so repeated positions are free). Exactly one of ``fitness_fn``
    (scalar, one RAV per call) or ``batch_fitness_fn`` (whole population per
    call) is required; with both given the batch hook wins.
    """
    if fitness_fn is None and batch_fitness_fn is None:
        raise TypeError("optimize() needs fitness_fn or batch_fitness_fn")
    space = SearchSpace(sp_max=sp_max, batch_max=batch_max)
    searcher = PSOSearcher(space, cfg or PSOConfig())
    return run_search(searcher, fitness_fn=fitness_fn,
                      batch_fitness_fn=batch_fitness_fn)
