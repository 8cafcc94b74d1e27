"""repro_torch.dse — the port's multi-objective DSE campaigns.

The port's copy of the JAX package's ``repro.dse`` (NumPy throughout; it
imports no JAX), cut to what this slice ports:

1. *Backends* — :mod:`repro_torch.dse.backends`: the ``fpga`` backend
   sweeps (network x input size x FPGA x precision x batch cap) with one
   search per cell. The ``tpu`` and ``cuda`` backends are not ported yet
   and are refused by name.
2. *Campaign running* — :mod:`repro_torch.dse.campaign` fans the cells out
   over a process pool with deterministic per-cell seeds; hyperband's
   rung-0 screen of every cell runs in one cross-cell call on the card
   (:func:`repro_torch.dse.campaign.prescreen_cells`).
3. *Multi-objective evaluation* — :mod:`repro_torch.dse.objectives`.
4. *Frontier extraction* — :mod:`repro_torch.dse.pareto` and
   :mod:`repro_torch.dse.frontier`.
5. *Persistence* — :mod:`repro_torch.dse.store`, the JSONL store, whose
   records are the reference's: either package resumes the other's store.
6. *Resilience* — :mod:`repro_torch.dse.resilience`: retries, timeouts,
   pool rebuilds and quarantine.

Reports (``report.py``), placement (``placement.py``) and the telemetry
CLI (``obs.py``) are not ported yet.

    python -m repro_torch.dse.campaign --nets vgg16 --fpgas ku115,zcu102 \\
        --precisions 16,8 --searcher hyperband --store results/dse.jsonl
"""
from .objectives import (NORMALIZED_DEFAULT_WEIGHTS, NORMALIZED_OBJECTIVES,
                         OBJECTIVES, ObjectiveSpec, Objectives,
                         canonical_vector, normalized_throughput,
                         scalarize_values, scalarized_objective)
from .frontier import FrontierIndex
from .pareto import (crowding_distance, diverse_front, dominance_split,
                     dominates, non_dominated, nondominated_sort,
                     pareto_front, select_diverse)

# Campaign/backend/store exports resolve lazily (PEP 562) so
# `python -m repro_torch.dse.campaign` / `python -m repro_torch.dse.store`
# don't import their module twice (runpy's found-in-sys.modules warning).
_CAMPAIGN_EXPORTS = ("CampaignCell", "CampaignReport", "cell_seed",
                     "expand_cells", "prescreen_cells", "run_campaign",
                     "run_cell")
_BACKEND_EXPORTS = ("BACKENDS", "Backend", "FPGABackend", "get_backend")
_STORE_EXPORTS = ("CampaignStore", "ResultStore", "is_ok", "open_store",
                  "rav_hash", "record_status")
_RESILIENCE_EXPORTS = ("CellOutcome", "CellTimeout", "CorruptRecord",
                       "RetryPolicy", "WorkerCrash", "execute_cell",
                       "interrupt_scope", "quarantine_record",
                       "run_resilient_pool")

__all__ = [
    *_CAMPAIGN_EXPORTS, *_BACKEND_EXPORTS, *_STORE_EXPORTS,
    *_RESILIENCE_EXPORTS,
    "NORMALIZED_DEFAULT_WEIGHTS", "NORMALIZED_OBJECTIVES",
    "OBJECTIVES", "ObjectiveSpec", "Objectives", "canonical_vector",
    "normalized_throughput", "scalarize_values", "scalarized_objective",
    "crowding_distance", "diverse_front", "dominance_split", "dominates",
    "non_dominated", "nondominated_sort", "pareto_front", "select_diverse",
    "FrontierIndex",
]


def __getattr__(name: str):
    if name in _CAMPAIGN_EXPORTS:
        from . import campaign
        return getattr(campaign, name)
    if name in _BACKEND_EXPORTS:
        from . import backends
        return getattr(backends, name)
    if name in _STORE_EXPORTS:
        from . import store
        return getattr(store, name)
    if name in _RESILIENCE_EXPORTS:
        from . import resilience
        return getattr(resilience, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
