"""Pluggable search engines over the RAV: the ask/tell ``Searcher``
protocol, the budget-accounting driver, and the engine registry.

The paper fixes one global optimizer (PSO, Algorithm 1), but engine
choice and multi-fidelity screening dominate search quality at fixed
compute (arXiv:1903.07676, arXiv:2104.02251). This module factors the
search loop out of :mod:`repro.core.pso` so any engine can drive the
same batched fitness path:

* a :class:`Searcher` *asks* for a population block of RAV positions and
  is *told* their fitnesses; it never calls the models itself;
* :func:`run_search` owns what every engine shares — the rounded-RAV
  memo cache (dedup in first-appearance order, exactly the old PSO
  loop's semantics, so trajectories stay bit-identical), evaluation /
  cache-hit / screened counters, and assembly of the final
  :class:`SearchResult`;
* engines declare a per-block ``fidelity``: ``"full"`` routes through
  the batched Algorithm-2+3 evaluation, ``"screen"`` through the cheap
  vectorized relaxation (:func:`repro.core.batch_eval.screen_rav_batch`)
  that multi-fidelity search uses to triage thousands of candidates.

Registered engines (``SEARCHERS``): ``pso`` (the paper's Algorithm 1,
lives in :mod:`repro.core.pso`), ``random`` (uniform baseline),
``anneal`` (geometric-cooling simulated annealing over a population of
independent chains), and ``hyperband`` (successive halving: screen
thousands of RAVs at the capped-budget fidelity, promote the survivors
to full Algorithm-2+3 evaluation, then refine with a survivor-seeded
PSO).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .local_opt import RAV

#: Fraction bounds shared by every engine (the PSO's historical bounds).
FRAC_LO, FRAC_HI = 0.05, 0.95


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The 5-dim RAV box: [SP, Batch, dsp_frac, bram_frac, bw_frac]."""

    sp_max: int
    batch_max: int = 1

    def lo(self) -> np.ndarray:
        return np.array([0.0, 1.0, FRAC_LO, FRAC_LO, FRAC_LO])

    def hi(self) -> np.ndarray:
        return np.array([float(self.sp_max), float(self.batch_max),
                         FRAC_HI, FRAC_HI, FRAC_HI])

    def canonical(self) -> np.ndarray:
        """The three seed particles every engine plants: pure-generic,
        half-split, pure-pipeline (covers the paradigm extremes)."""
        return np.array([
            [0.0, 1.0, FRAC_LO, FRAC_LO, FRAC_LO],
            [self.sp_max / 2, 1.0, 0.5, 0.5, 0.5],
            [float(self.sp_max), 1.0, FRAC_HI, FRAC_HI, FRAC_HI],
        ])

    def to_rav(self, pos: np.ndarray) -> RAV:
        return RAV(sp=int(round(pos[0])), batch=max(1, int(round(pos[1]))),
                   dsp_frac=float(pos[2]), bram_frac=float(pos[3]),
                   bw_frac=float(pos[4]))


@dataclasses.dataclass
class SearchResult:
    """What any engine's search produced. Field order (and defaults) are
    the historical ``PSOResult`` layout — positional construction from
    older code keeps working, and ``repro.core.pso.PSOResult`` is an
    alias of this class."""

    best_rav: RAV
    best_fitness: float
    iterations_run: int
    evaluations: int
    history: list[float]
    #: Why the search stopped: ``"converged"`` (patience exhausted — the
    #: paper's early termination) or ``"iteration_cap"`` (budget ran out
    #: while the best was still moving — the signal multi-fidelity DSE
    #: uses to promote survivors to a deeper search).
    stop_reason: str = "iteration_cap"
    #: Fitness lookups served from the rounded-RAV memo instead of the
    #: analytical models (``evaluations`` counts the model calls).
    cache_hits: int = 0
    #: Registry name of the engine that produced this result.
    engine: str = "pso"
    #: Candidates triaged through the cheap screening fidelity
    #: (:func:`repro.core.batch_eval.screen_rav_batch`); these never
    #: touch the full models and are NOT counted in ``evaluations``.
    screened: int = 0


class Searcher:
    """Ask/tell engine protocol. Subclasses keep all algorithm state;
    the driver (:func:`run_search`) keeps all bookkeeping.

    Contract per round: :meth:`ask` returns a ``(n, 5)`` position block
    (or ``None`` when done); the driver evaluates it at the engine's
    current :attr:`fidelity` and calls :meth:`tell` with the fitness
    array. After ``tell`` the engine must expose ``best_pos``,
    ``best_fit``, ``history`` (best-so-far per iteration),
    ``iterations_run``, ``stop_reason``, and ``done``.
    """

    #: Registry name; subclasses override.
    name = "base"
    #: Fidelity of the NEXT asked block: ``"full"`` or ``"screen"``.
    fidelity = "full"

    def __init__(self, space: SearchSpace, cfg):
        self.space = space
        self.cfg = cfg
        self.done = False
        self.stop_reason = "iteration_cap"
        self.history: list[float] = []
        self.iterations_run = 0
        self.best_pos: np.ndarray | None = None
        self.best_fit = float("-inf")

    def ask(self) -> np.ndarray | None:  # pragma: no cover - interface
        raise NotImplementedError

    def tell(self, fits: np.ndarray) -> None:  # pragma: no cover
        raise NotImplementedError

    def eval_cap(self) -> int:
        """Upper bound on full-fidelity evaluations this engine may
        request (budget the conformance tests hold every engine to)."""
        return self.cfg.eval_cap()


def _cache_key(rav: RAV) -> tuple:
    # Round fractions to 2 decimals for cache hits without losing much.
    t = rav.as_tuple()
    return (t[0], t[1], round(t[2], 2), round(t[3], 2), round(t[4], 2))


def run_search(searcher: Searcher, *,
               fitness_fn: Callable[[RAV], float] | None = None,
               batch_fitness_fn: Callable[[Sequence[RAV]], Sequence[float]] | None = None,
               screen_fn: Callable[[Sequence[RAV]], np.ndarray] | None = None,
               ) -> SearchResult:
    """Drive one engine to completion and account for its budget.

    Exactly one of ``fitness_fn`` (scalar) or ``batch_fitness_fn``
    (population per call) is required; with both given the batch hook
    wins. ``screen_fn`` serves ``"screen"``-fidelity blocks — it is
    called with the raw ``(n, 5)`` position array, not RAV objects (an
    engine asking for screening without one is an error). Full-fidelity
    results
    are memoized on the rounded RAV — uncached keys are deduped in
    first-appearance order and go through ONE batched call, exactly the
    semantics of the pre-protocol PSO loop (bit-identity depends on it).
    """
    if fitness_fn is None and batch_fitness_fn is None:
        raise TypeError("run_search() needs fitness_fn or batch_fitness_fn")
    space = searcher.space
    cache: dict[tuple, float] = {}
    evals = hits = screened = 0

    def fit_batch(block: np.ndarray) -> np.ndarray:
        nonlocal evals, hits
        ravs = [space.to_rav(p) for p in block]
        keys = [_cache_key(r) for r in ravs]
        pending: dict[tuple, RAV] = {}
        for k, r in zip(keys, ravs):
            if k not in cache and k not in pending:
                pending[k] = r
        if pending:
            if batch_fitness_fn is not None:
                vals = batch_fitness_fn(list(pending.values()))
            else:
                vals = [fitness_fn(r) for r in pending.values()]
            for k, v in zip(pending, vals):
                cache[k] = float(v)
            evals += len(pending)
        hits += len(keys) - len(pending)
        return np.array([cache[k] for k in keys])

    while True:
        block = searcher.ask()
        if block is None:
            break
        if searcher.fidelity == "screen":
            if screen_fn is None:
                raise ValueError(
                    f"searcher {searcher.name!r} asked for screen-fidelity "
                    f"evaluation but no screen_fn was provided")
            # The raw (n, 5) position block goes straight through —
            # materializing n RAV objects would cost more than the
            # entire vectorized screen.
            fits = np.asarray(screen_fn(block), dtype=float)
            screened += len(block)
        else:
            fits = fit_batch(block)
        searcher.tell(fits)

    return SearchResult(space.to_rav(searcher.best_pos),
                        float(searcher.best_fit), searcher.iterations_run,
                        evals, searcher.history,
                        stop_reason=searcher.stop_reason, cache_hits=hits,
                        engine=searcher.name, screened=screened)


# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------

#: name -> (searcher class, config class). Engines self-register at
#: import; :func:`_load_engines` pulls in the out-of-module ones.
SEARCHERS: dict[str, tuple[type, type]] = {}


def register_searcher(name: str, searcher_cls: type, config_cls: type) -> None:
    SEARCHERS[name] = (searcher_cls, config_cls)


def _load_engines() -> None:
    from . import pso  # noqa: F401  (registers "pso" on import)


def searcher_names() -> list[str]:
    _load_engines()
    return sorted(SEARCHERS)


def searcher_config_for(name: str, *, base: dict | None = None,
                        overrides: dict | None = None):
    """Build a registered engine's config instance — the exact object
    :func:`make_searcher` would hand its searcher, factored out so
    campaign-level precomputation (e.g. the cross-cell jax screen, which
    must reproduce each cell's hyperband config bit-for-bit) shares one
    construction path with the search itself.

    ``base`` carries the campaign-level knobs every engine understands
    (``population``, ``iterations``, ``patience``, ``seed``) — keys the
    engine's config class lacks are dropped. ``overrides`` is the
    ``--searcher-config`` dict and must name real config fields (typos
    raise with the valid field list)."""
    _load_engines()
    if name not in SEARCHERS:
        raise ValueError(f"unknown searcher {name!r}; "
                         f"registered: {', '.join(sorted(SEARCHERS))}")
    _, config_cls = SEARCHERS[name]
    fields = {f.name: f for f in dataclasses.fields(config_cls)}
    kw = {k: v for k, v in (base or {}).items() if k in fields}
    for k, v in (overrides or {}).items():
        if k not in fields:
            raise ValueError(
                f"searcher {name!r} has no config field {k!r}; "
                f"valid: {', '.join(sorted(fields))}")
        # Coerce to the field's default's type so "--searcher-config
        # screen=512" (a string from the CLI) lands as the right kind.
        kw[k] = type(fields[k].default)(v)
    return config_cls(**kw)


def make_searcher(name: str, space: SearchSpace, *, base: dict | None = None,
                  overrides: dict | None = None) -> Searcher:
    """Instantiate a registered engine (see :func:`searcher_config_for`
    for how ``base`` and ``overrides`` assemble its config)."""
    cfg = searcher_config_for(name, base=base, overrides=overrides)
    searcher_cls, _ = SEARCHERS[name]
    return searcher_cls(space, cfg)


# ---------------------------------------------------------------------------
# random: uniform-sampling baseline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RandomConfig:
    population: int = 24
    iterations: int = 40
    patience: int = 0        # 0 = no early termination
    seed: int = 0

    def eval_cap(self) -> int:
        return self.population * (self.iterations + 1)


class RandomSearcher(Searcher):
    """Uniform random search: one fresh population per iteration, the
    three canonical particles planted in the first. The floor any real
    engine must beat at equal budget."""

    name = "random"

    def __init__(self, space: SearchSpace, cfg: RandomConfig):
        super().__init__(space, cfg)
        self._rng = np.random.default_rng(cfg.seed)
        self._stale = 0
        self._first = True

    def ask(self) -> np.ndarray | None:
        if self.done:
            return None
        pos = self._rng.uniform(self.space.lo(), self.space.hi(),
                                size=(self.cfg.population, 5))
        if self._first:
            can = self.space.canonical()
            pos[:len(can)] = can
        self._pos = pos
        return pos

    def tell(self, fits: np.ndarray) -> None:
        i = int(np.argmax(fits))
        improved = bool(fits[i] > self.best_fit)
        if improved:
            self.best_pos, self.best_fit = self._pos[i].copy(), float(fits[i])
        if self._first:
            self._first = False
            self.history = [self.best_fit]
            if self.cfg.iterations <= 0:
                self.done = True
            return
        self.iterations_run += 1
        self.history.append(self.best_fit)
        self._stale = 0 if improved else self._stale + 1
        if self.cfg.patience and self._stale >= self.cfg.patience:
            self.stop_reason = "converged"
            self.done = True
        elif self.iterations_run >= self.cfg.iterations:
            self.done = True


# ---------------------------------------------------------------------------
# anneal: geometric-cooling simulated annealing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AnnealConfig:
    population: int = 24     # independent chains
    iterations: int = 40
    patience: int = 0        # 0 = no early termination
    seed: int = 0
    t0: float = 0.05         # initial temperature, relative to |best|
    cooling: float = 0.85    # geometric cooling factor per iteration
    step: float = 0.25       # proposal width, fraction of each axis range

    def eval_cap(self) -> int:
        return self.population * (self.iterations + 1)


class AnnealSearcher(Searcher):
    """Simulated annealing over a population of independent chains with
    a geometric cooling schedule (the fpgaHART-style sweep config:
    ``t0``/``cooling``/``step``). Proposals are Gaussian steps whose
    width shrinks with the temperature; uphill moves always accepted,
    downhill with probability ``exp(dfit / T)`` where ``T`` is scaled by
    the first population's best so the schedule is objective-magnitude
    invariant."""

    name = "anneal"

    def __init__(self, space: SearchSpace, cfg: AnnealConfig):
        super().__init__(space, cfg)
        self._rng = np.random.default_rng(cfg.seed)
        self._lo, self._hi = space.lo(), space.hi()
        pos = self._rng.uniform(self._lo, self._hi,
                                size=(cfg.population, 5))
        can = space.canonical()
        pos[:len(can)] = can
        self._pos = pos
        self._cur = None          # accepted positions after the init tell
        self._cur_fit = None
        self._temp = 0.0
        self._scale = 1.0         # proposal-width factor, cools with T
        self._stale = 0

    def ask(self) -> np.ndarray | None:
        if self.done:
            return None
        if self._cur is None:     # initial population
            return self._pos
        width = self.cfg.step * (self._hi - self._lo) * self._scale
        noise = self._rng.normal(0.0, 1.0, size=self._cur.shape)
        self._pos = np.clip(self._cur + noise * width, self._lo, self._hi)
        return self._pos

    def tell(self, fits: np.ndarray) -> None:
        i = int(np.argmax(fits))
        improved = bool(fits[i] > self.best_fit)
        if improved:
            self.best_pos, self.best_fit = self._pos[i].copy(), float(fits[i])
        if self._cur is None:     # init round: seed chains + temperature
            self._cur, self._cur_fit = self._pos.copy(), fits.copy()
            self._temp = self.cfg.t0 * max(1.0, abs(self.best_fit))
            self.history = [self.best_fit]
            if self.cfg.iterations <= 0:
                self.done = True
            return
        delta = fits - self._cur_fit
        accept = delta > 0
        if self._temp > 0:
            u = self._rng.random(len(fits))
            accept |= u < np.exp(np.minimum(0.0, delta) / self._temp)
        self._cur = np.where(accept[:, None], self._pos, self._cur)
        self._cur_fit = np.where(accept, fits, self._cur_fit)
        self._temp *= self.cfg.cooling
        self._scale *= self.cfg.cooling
        self.iterations_run += 1
        self.history.append(self.best_fit)
        self._stale = 0 if improved else self._stale + 1
        if self.cfg.patience and self._stale >= self.cfg.patience:
            self.stop_reason = "converged"
            self.done = True
        elif self.iterations_run >= self.cfg.iterations:
            self.done = True


# ---------------------------------------------------------------------------
# hyperband: successive halving over the two fidelity tiers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HyperbandConfig:
    #: Rung-0 candidates triaged through the screening fidelity.
    screen: int = 4096
    #: Survivors promoted from the screen to full Algorithm-2+3
    #: evaluation (after dedup at the memo-cache resolution).
    survivors: int = 16
    #: Survivor-seeded refinement PSO: swarm size / iteration budget.
    population: int = 12
    iterations: int = 8
    patience: int = 2
    seed: int = 0

    def eval_cap(self) -> int:
        # +3: the canonical particles are always promoted alongside the
        # screened survivors.
        return self.survivors + 3 + self.population * (self.iterations + 1)


def hyperband_rung0(space: SearchSpace, cfg: "HyperbandConfig") -> np.ndarray:
    """The exact ``(screen, 5)`` rung-0 block a
    :class:`HyperbandSearcher` with this config will ask to have
    screened: ``cfg.screen`` uniform draws from a fresh
    ``default_rng(cfg.seed)`` with the canonical three planted at the
    top. Factored out so the campaign-level cross-cell jax screen
    (:mod:`repro.core.screen_jax`) can precompute every cell's rung-0
    fitnesses in one jitted call and hand them back to the searcher —
    bit-identical positions are what makes that handoff sound."""
    rng = np.random.default_rng(cfg.seed)
    pos = rng.uniform(space.lo(), space.hi(), size=(cfg.screen, 5))
    can = space.canonical()
    pos[:len(can)] = can
    return pos


class HyperbandSearcher(Searcher):
    """Successive-halving multi-fidelity search.

    Rung 0 *screens* ``screen`` uniform candidates (plus the canonical
    three) through the vectorized roofline relaxation
    (:func:`repro.core.batch_eval.screen_rav_batch`) — the batched
    engine at a capped budget: parallelism relaxed to the continuous
    roofline, zero Algorithm-2/3 refinement iterations. The top
    ``survivors`` (deduped at the memo-cache resolution, so no full
    evaluation is wasted on a rounded duplicate) are promoted to full
    Algorithm-2+3 evaluation, and a short PSO seeded with the ranked
    survivors polishes the winner — so the result is never worse than
    the best survivor, and the effective search space is the screen
    size, ~2 orders of magnitude beyond what pure PSO visits at equal
    wall-clock."""

    name = "hyperband"
    fidelity = "screen"

    def __init__(self, space: SearchSpace, cfg: HyperbandConfig):
        super().__init__(space, cfg)
        self._phase = "screen"
        self._inner = None
        self._promoted: np.ndarray | None = None

    def ask(self) -> np.ndarray | None:
        if self.done:
            return None
        if self._phase == "screen":
            self._pos = hyperband_rung0(self.space, self.cfg)
            return self._pos
        if self._phase == "promote":
            return self._promoted
        return self._inner.ask()    # refine: delegate to the seeded PSO

    def tell(self, fits: np.ndarray) -> None:
        if self._phase == "screen":
            # Survivors = the canonical three (always — the screening
            # proxy must never be able to discard the paradigm extremes
            # every other engine evaluates at full fidelity) plus the
            # top screened candidates, deduped at the memo resolution.
            rows, seen = [], set()
            for p in self.space.canonical():
                key = _cache_key(self.space.to_rav(p))
                if key not in seen:
                    seen.add(key)
                    rows.append(p)
            cap = self.cfg.survivors + len(rows)
            for i in np.argsort(-fits, kind="stable"):
                if len(rows) >= cap:
                    break
                key = _cache_key(self.space.to_rav(self._pos[i]))
                if key in seen:
                    continue
                seen.add(key)
                rows.append(self._pos[i])
            self._promoted = np.array(rows)
            self._phase, self.fidelity = "promote", "full"
            return
        if self._phase == "promote":
            from .pso import PSOConfig, PSOSearcher
            i = int(np.argmax(fits))
            self.best_pos = self._promoted[i].copy()
            self.best_fit = float(fits[i])
            self.history = [self.best_fit]
            order = np.argsort(-fits, kind="stable")
            seeds = self._promoted[order[:self.cfg.population]]
            inner_cfg = PSOConfig(population=self.cfg.population,
                                  iterations=self.cfg.iterations,
                                  patience=self.cfg.patience,
                                  seed=self.cfg.seed + 1)
            self._inner = PSOSearcher(self.space, inner_cfg,
                                      init_positions=seeds)
            self._phase = "refine"
            return
        self._inner.tell(fits)
        if self._inner.best_fit > self.best_fit:
            self.best_pos = self._inner.best_pos.copy()
            self.best_fit = float(self._inner.best_fit)
        if self._inner.done:
            self.done = True
            self.history = self.history + self._inner.history
            self.iterations_run = self._inner.iterations_run
            self.stop_reason = self._inner.stop_reason


register_searcher("random", RandomSearcher, RandomConfig)
register_searcher("anneal", AnnealSearcher, AnnealConfig)
register_searcher("hyperband", HyperbandSearcher, HyperbandConfig)
