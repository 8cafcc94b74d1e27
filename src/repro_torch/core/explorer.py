"""DNNExplorer's 3-step design flow (paper Fig. 4):

1. *Model/HW Analysis* — :mod:`repro.core.netinfo` profiles the DNN.
2. *Accelerator Modeling* — :mod:`repro.core.pipeline_model` +
   :mod:`repro.core.generic_model` provide the analytical models
   (:mod:`repro.core.batch_eval` evaluates them population-at-a-time).
3. *Architecture Exploration* — a pluggable search engine over the RAV
   (:mod:`repro.core.search`; default is the paper's PSO, Algorithm 1)
   with local optimizers inside the fitness
   (:mod:`repro.core.local_opt`).

This module runs the flow for ONE (DNN, FPGA) pair and one scalar
objective — the paper's Table 3 setting. Campaign-scale sweeps over many
(network x input x FPGA x precision x batch) cells with multi-objective
Pareto frontiers live in :mod:`repro.dse`, which builds on this entry
point.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from .batch_eval import evaluate_rav_batch, screen_rav_batch
from .hw_specs import FPGASpec
from .local_opt import RAV, DesignPoint, evaluate_rav
from .netinfo import NetInfo
from .pso import PSOConfig, PSOResult, PSOSearcher, optimize  # noqa: F401
from .search import SearchSpace, make_searcher, run_search


#: Version stamp on the per-cell convergence ``trace`` dict (bump on
#: breaking change; readers must tolerate records without the field —
#: pre-trace stores resume unchanged).
TRACE_SCHEMA_VERSION = 1


@dataclasses.dataclass
class ExplorationResult:
    net: str
    fpga: str
    design: DesignPoint
    #: The search engine's result — historically always PSO's, now any
    #: registered engine's (:class:`repro.core.search.SearchResult`;
    #: the field name is kept for compatibility).
    pso: PSOResult
    search_time_s: float

    @property
    def rav_pretty(self) -> str:
        r = self.design.rav
        return (f"[SP={r.sp}, Batch={r.batch}, DSP={r.dsp_frac:.1%}, "
                f"BRAM={r.bram_frac:.1%}, BW={r.bw_frac:.1%}]")

    def convergence_trace(self) -> dict:
        """The paper's Fig.-8-style search-efficiency curve as a
        JSON-native dict: per-iteration best fitness, improvement tail,
        and why the search stopped. Rides in the campaign store record
        under ``trace``, so convergence diagnostics (which cells were
        still improving when the iteration cap hit) come from the store
        alone — no re-run needed. Multi-fidelity engines additionally
        report ``screened`` (candidates triaged through the cheap
        relaxation, never fully evaluated)."""
        p = self.pso
        hist = [round(float(h), 6) for h in p.history]
        trace = {
            "schema": TRACE_SCHEMA_VERSION,
            "engine": p.engine,
            "stop_reason": p.stop_reason,
            "iterations": p.iterations_run,
            "evaluations": p.evaluations,
            "cache_hits": p.cache_hits,
            "best_fitness": float(p.best_fitness),
            "final_delta": round(hist[-1] - hist[-2], 6)
            if len(hist) > 1 else 0.0,
            "history": hist,
        }
        if p.screened:
            trace["screened"] = p.screened
        return trace


def explore(net: NetInfo, fpga: FPGASpec, dw: int = 16, ww: int = 16,
            batch_max: int = 1, cfg: PSOConfig | None = None,
            objective: Callable[[DesignPoint], float] | None = None,
            searcher: str = "pso", searcher_config: dict | None = None,
            screen_fits: np.ndarray | None = None,
            ) -> ExplorationResult:
    """Run the full DNNExplorer flow for one (DNN, FPGA) pair.

    ``objective`` scalarizes a :class:`DesignPoint` into the fitness the
    search maximizes; the default is feasible throughput
    (``DesignPoint.fitness``), which keeps the paper's single-objective
    behavior. :mod:`repro.dse` passes weighted multi-objective
    scalarizations here.

    ``searcher`` picks the engine from the registry
    (:data:`repro.core.search.SEARCHERS`; default ``"pso"``, the
    paper's Algorithm 1) and ``searcher_config`` overrides that
    engine's config fields. ``cfg`` keeps its historical meaning: its
    population / iterations / patience / seed carry over to whichever
    engine runs (engines ignore knobs they don't have).

    The engine's fitness hook evaluates each population through the
    batched array-kernel engine (:mod:`repro.core.batch_eval`), which
    shares packed layer and per-split cycle tables across the whole
    search; multi-fidelity engines triage candidates through the
    vectorized screening relaxation
    (:func:`~repro.core.batch_eval.screen_rav_batch`) first. The
    winning RAV is re-evaluated once through the scalar reference path
    (:func:`~repro.core.local_opt.evaluate_rav`), so the returned
    design always comes from the reference implementation.

    ``screen_fits`` optionally supplies the FIRST screen-fidelity
    block's fitnesses, precomputed by the campaign-level cross-cell jax
    screen (:mod:`repro.core.screen_jax`): the engine's opening rung-0
    ask is served from it (lengths must match — a config drift falls
    back to the NumPy screen) and every later screen call goes through
    :func:`~repro.core.batch_eval.screen_rav_batch` as usual. Because
    the jax kernel is bit-identical to the NumPy reference and
    :func:`repro.core.search.hyperband_rung0` makes the asked positions
    deterministic, serving precomputed fitnesses leaves the search
    trajectory unchanged.
    """
    t0 = time.perf_counter()
    sp_max = len(net.major_layers)
    obj = objective if objective is not None else (lambda d: d.fitness)
    cfg = cfg or PSOConfig()

    def batch_fitness(ravs: list[RAV]) -> list[float]:
        """Whole-population fitness: one batched-engine call per step."""
        return [obj(d) for d in evaluate_rav_batch(net, fpga, ravs, dw, ww)]

    pre = ([np.asarray(screen_fits, dtype=float)]
           if screen_fits is not None else [])

    def screen(block: np.ndarray) -> np.ndarray:
        """Cheap-fidelity triage over a raw position block: relaxed
        throughput, NOT ``objective`` — multi-fidelity engines rank
        rungs on it, then score survivors with the true objective at
        full fidelity. A precomputed ``screen_fits`` serves the first
        matching block once; everything else hits the NumPy screen."""
        if pre and len(block) == len(pre[0]):
            return pre.pop()
        return screen_rav_batch(net, fpga, block, dw, ww)

    space = SearchSpace(sp_max=sp_max, batch_max=batch_max)
    if searcher == "pso" and not searcher_config:
        engine = PSOSearcher(space, cfg)    # the paper's exact path
    else:
        base = dict(population=cfg.population, iterations=cfg.iterations,
                    patience=cfg.patience, seed=cfg.seed)
        engine = make_searcher(searcher, space, base=base,
                               overrides=searcher_config)
    res = run_search(engine, batch_fitness_fn=batch_fitness, screen_fn=screen)
    design = evaluate_rav(net, fpga, res.best_rav, dw, ww)
    return ExplorationResult(net.name, fpga.name, design, res,
                             time.perf_counter() - t0)
