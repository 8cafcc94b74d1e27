"""repro_torch.dse — the port's multi-objective DSE campaigns.

The port's copy of the JAX package's ``repro.dse``: NumPy throughout, it
imports no JAX. Its modules are the reference's, but for one thing: the
hyperband searcher's rung-0 screen of every fpga cell runs in one
cross-cell call on the card
(:func:`repro_torch.dse.campaign.prescreen_cells`), where the reference
calls its jax screen.

1. *Backends* — :mod:`repro_torch.dse.backends` gives each device family a
   campaign contract: an objective schema, cell expansion over that
   family's axes, per-cell evaluation, and a resume-match search config.
   The ``fpga`` backend (default) sweeps (network x input size x FPGA x
   precision x batch cap) with one search per cell; the ``tpu`` backend
   sweeps (arch x shape x chip count x remat x microbatches) through the
   analytic planner in :mod:`repro_torch.core.tpu_planner`; the ``cuda``
   backend adds a GPU-part axis (A100-40G/A100-80G/H100) over the GPU
   roofline in :mod:`repro_torch.core.gpu_model` /
   :mod:`repro_torch.core.gpu_planner`.
2. *Campaign running* — :mod:`repro_torch.dse.campaign` fans a backend's
   cells out over a process pool with deterministic per-cell seeds,
   collecting records into a resumable JSONL store as they finish.
3. *Multi-objective evaluation* — :mod:`repro_torch.dse.objectives`, and
   the normalized cross-backend schema every backend emits via
   ``Backend.normalized(record)``.
4. *Frontier extraction* — :mod:`repro_torch.dse.pareto` and
   :mod:`repro_torch.dse.frontier`.
5. *Persistence* — :mod:`repro_torch.dse.store`, the JSONL store, whose
   records are the reference's: either package resumes the other's store.
6. *Reporting* — :mod:`repro_torch.dse.report` renders a store into a
   Markdown campaign report (``--compare A B`` for the trajectory between
   stores); :mod:`repro_torch.dse.placement` picks a device family and
   part per workload under a cost envelope; :mod:`repro_torch.dse.obs`
   summarizes, validates and exports a ``--trace`` campaign's events.
7. *Resilience* — :mod:`repro_torch.dse.resilience`: retries, timeouts,
   pool rebuilds and quarantine.

Quickstart::

    python -m repro_torch.dse.campaign --nets vgg16 --fpgas ku115,zcu102 \\
        --precisions 16,8 --searcher hyperband --store results/dse.jsonl

    python -m repro_torch.dse.campaign --backend tpu \\
        --archs starcoder2-3b,xlstm-350m --shapes train_4k,decode_32k \\
        --chips 8,16,32 --store results/dse_tpu.jsonl

    python -m repro_torch.dse.campaign --backend cuda --archs starcoder2-3b \\
        --shapes train_4k,decode_32k --gpus 8,16,32 \\
        --gpu-types a100-80g,h100 --store results/dse_cuda.jsonl

    python -m repro_torch.dse.report results/dse_cuda.jsonl --out report.md
"""
from .objectives import (NORMALIZED_DEFAULT_WEIGHTS, NORMALIZED_OBJECTIVES,
                         OBJECTIVES, ObjectiveSpec, Objectives,
                         canonical_vector, normalized_throughput,
                         scalarize_values, scalarized_objective)
from .frontier import FrontierIndex
from .pareto import (crowding_distance, diverse_front, dominance_split,
                     dominates, non_dominated, nondominated_sort,
                     pareto_front, select_diverse)

# Campaign/backend/report/store exports resolve lazily (PEP 562) so
# `python -m repro_torch.dse.campaign` / `python -m repro_torch.dse.report` /
# `python -m repro_torch.dse.store` don't import their module twice (runpy's
# found-in-sys.modules warning).
_CAMPAIGN_EXPORTS = ("CampaignCell", "CampaignReport", "cell_seed",
                     "expand_cells", "prescreen_cells", "run_campaign",
                     "run_cell")
_BACKEND_EXPORTS = ("BACKENDS", "Backend", "CUDABackend", "CUDACell",
                    "FPGABackend", "GPU_OBJECTIVES", "TPUBackend",
                    "TPUCell", "TPU_OBJECTIVES", "get_backend",
                    "workload_families")
_REPORT_EXPORTS = ("fixture_events", "fixture_records", "health_section",
                   "render_compare", "render_placement", "render_report")
_OBS_EXPORTS = ("events_for_store", "example_health_md")
_STORE_EXPORTS = ("CampaignStore", "ResultStore", "is_ok", "open_store",
                  "rav_hash", "record_status")
_RESILIENCE_EXPORTS = ("CellOutcome", "CellTimeout", "CorruptRecord",
                       "RetryPolicy", "WorkerCrash", "execute_cell",
                       "interrupt_scope", "quarantine_record",
                       "run_resilient_pool")
_PLACEMENT_EXPORTS = ("Assignment", "BudgetInfeasibleError", "Candidate",
                      "CoverageError", "PlacementError", "PlacementResult",
                      "candidates_by_workload", "ensure_coverage",
                      "marginal_upgrades", "parse_workloads", "place",
                      "pooled_records", "prune_candidates")

__all__ = [
    *_CAMPAIGN_EXPORTS, *_BACKEND_EXPORTS, *_REPORT_EXPORTS,
    *_PLACEMENT_EXPORTS, *_OBS_EXPORTS, *_RESILIENCE_EXPORTS,
    "is_ok", "record_status",
    "NORMALIZED_DEFAULT_WEIGHTS", "NORMALIZED_OBJECTIVES",
    "OBJECTIVES", "ObjectiveSpec", "Objectives", "canonical_vector",
    "normalized_throughput", "scalarize_values", "scalarized_objective",
    "crowding_distance", "diverse_front", "dominance_split", "dominates",
    "non_dominated", "nondominated_sort", "pareto_front", "select_diverse",
    "CampaignStore", "FrontierIndex", "ResultStore", "open_store",
    "rav_hash",
]


def __getattr__(name: str):
    if name in _CAMPAIGN_EXPORTS:
        from . import campaign
        return getattr(campaign, name)
    if name in _BACKEND_EXPORTS:
        from . import backends
        return getattr(backends, name)
    if name in _REPORT_EXPORTS:
        from . import report
        return getattr(report, name)
    if name in _PLACEMENT_EXPORTS:
        from . import placement
        return getattr(placement, name)
    if name in _OBS_EXPORTS:
        from . import obs
        return getattr(obs, name)
    if name in _STORE_EXPORTS:
        from . import store
        return getattr(store, name)
    if name in _RESILIENCE_EXPORTS:
        from . import resilience
        return getattr(resilience, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
