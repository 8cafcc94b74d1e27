"""Multi-objective view of a design point, with scalarization knobs.

The analytical models already produce every quantity the related work ranks
on (HybridDNN: throughput + latency; Being-ahead: resource efficiency); a
campaign keeps all of them per design instead of collapsing to throughput
inside the fitness. ``Objectives.canonical()`` maps the vector to pure
maximization form (minimized objectives negated) so Pareto dominance and
weighted scalarization are sign-uniform downstream.

Two layers live here:

* the *generic* helpers (:func:`canonical_vector`,
  :func:`scalarize_values`) work on any ``{name: value}`` objectives dict
  against any :class:`ObjectiveSpec` schema — each campaign backend
  (:mod:`repro.dse.backends`) declares its own schema and reuses these;
* the *normalized* cross-backend schema (:data:`NORMALIZED_OBJECTIVES` +
  :func:`normalized_throughput`): delivered TFLOP/s, per watt, per
  dollar-proxy, and per peak TFLOP — units every device family can emit,
  so one frontier can compare FPGA, TPU, and GPU designs;
* the FPGA-specific :class:`Objectives` dataclass (the paper's five
  quantities) keeps the original typed API and record layout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

from repro_torch.core.local_opt import DesignPoint


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    name: str
    maximize: bool
    units: str


#: Campaign objective vector, in report order.
OBJECTIVES: tuple[ObjectiveSpec, ...] = (
    ObjectiveSpec("throughput_ips", True, "img/s"),
    ObjectiveSpec("gops", True, "GOP/s"),
    ObjectiveSpec("latency_s", False, "s"),
    ObjectiveSpec("dsp_eff", True, "frac"),
    ObjectiveSpec("bram_used", False, "blocks"),
)

OBJECTIVE_NAMES: tuple[str, ...] = tuple(s.name for s in OBJECTIVES)

#: The paper's original search objective (single-objective special case).
DEFAULT_WEIGHTS: Mapping[str, float] = {"throughput_ips": 1.0}


#: The cross-backend objective vector: every backend can express its
#: designs in these units (useful TFLOP/s achieved, then that throughput
#: normalized by board power, by an hourly dollar proxy, and by the
#: part's peak TFLOP/s), so ONE Pareto frontier can compare device
#: families. ``tflops_per_peak`` generalizes the paper's DSP efficiency
#: and the TPU side's MFU; the watt/dollar terms follow Being-ahead's
#: practice of ranking heterogeneous accelerators on delivered
#: performance per unit cost rather than raw throughput. All values are
#: analytic-model predictions (roofline upper bounds with recompute
#: FLOPs excluded from the numerator), comparable across families
#: because every family is modeled the same way — they rank designs,
#: they don't certify absolute hardware numbers.
NORMALIZED_OBJECTIVES: tuple[ObjectiveSpec, ...] = (
    ObjectiveSpec("tflops", True, "TFLOP/s"),
    ObjectiveSpec("tflops_per_watt", True, "TFLOP/s/W"),
    ObjectiveSpec("tflops_per_dollar", True, "TFLOP/s/($/h)"),
    ObjectiveSpec("tflops_per_peak", True, "frac"),
)

#: Raw delivered throughput ranks cross-backend winners by default;
#: re-weight with e.g. ``tflops_per_watt=1`` for efficiency frontiers.
NORMALIZED_DEFAULT_WEIGHTS: Mapping[str, float] = {"tflops": 1.0}


def normalized_throughput(tflops: float, watts: float, usd_per_hour: float,
                          peak_tflops: float, *,
                          feasible: bool = True) -> dict:
    """Fold one design's delivered TFLOP/s and its hardware's power/price/
    peak into the :data:`NORMALIZED_OBJECTIVES` vector. Each backend's
    ``normalized(record)`` reduces to this after computing its own
    delivered-throughput and hardware terms."""
    return {
        "tflops": tflops,
        "tflops_per_watt": tflops / watts if watts else 0.0,
        "tflops_per_dollar": tflops / usd_per_hour if usd_per_hour else 0.0,
        "tflops_per_peak": tflops / peak_tflops if peak_tflops else 0.0,
        "feasible": bool(feasible),
    }


def canonical_vector(values: Mapping[str, float],
                     specs: Sequence[ObjectiveSpec]) -> tuple[float, ...]:
    """``{name: value}`` -> maximization-form tuple in spec order
    (minimized objectives negated). Schema-generic: works for any
    backend's objective dict."""
    return tuple(float(values[s.name]) if s.maximize else -float(values[s.name])
                 for s in specs)


def scalarize_values(values: Mapping, specs: Sequence[ObjectiveSpec],
                     weights: Mapping[str, float] | None = None,
                     default_weights: Mapping[str, float] | None = None,
                     ) -> float:
    """Weighted sum over the canonical (max-form) vector of any backend's
    objectives dict. Infeasible designs (``values["feasible"]`` falsy)
    score 0.0. Unknown weight names raise ``KeyError``."""
    if not values.get("feasible", True):
        return 0.0
    w = weights if weights is not None else (default_weights or
                                             {specs[0].name: 1.0})
    names = tuple(s.name for s in specs)
    canon = dict(zip(names, canonical_vector(values, specs)))
    unknown = set(w) - set(canon)
    if unknown:
        raise KeyError(f"unknown objectives: {sorted(unknown)}; "
                       f"choose from {names}")
    return sum(wi * canon[n] for n, wi in w.items())


@dataclasses.dataclass(frozen=True)
class Objectives:
    throughput_ips: float
    gops: float
    latency_s: float
    dsp_eff: float
    bram_used: float
    feasible: bool = True

    @classmethod
    def from_design(cls, d: DesignPoint) -> "Objectives":
        return cls(throughput_ips=d.throughput_ips, gops=d.gops,
                   latency_s=d.latency_s, dsp_eff=d.dsp_eff,
                   bram_used=float(d.bram_used), feasible=d.feasible)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "Objectives":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    def canonical(self, names: Sequence[str] = OBJECTIVE_NAMES,
                  ) -> tuple[float, ...]:
        """Maximization-form vector (minimized objectives negated)."""
        sense = {s.name: s.maximize for s in OBJECTIVES}
        vals = dataclasses.asdict(self)
        return tuple(vals[n] if sense[n] else -vals[n] for n in names)

    def scalarize(self, weights: Mapping[str, float] | None = None) -> float:
        """Weighted sum over the canonical (max-form) vector. Infeasible
        designs score 0.0 — with ``DEFAULT_WEIGHTS`` this equals
        :attr:`DesignPoint.fitness` exactly."""
        return scalarize_values(self.as_dict(), OBJECTIVES, weights,
                                DEFAULT_WEIGHTS)


def scalarized_objective(weights: Mapping[str, float] | None = None,
                         ) -> Callable[[DesignPoint], float]:
    """A ``DesignPoint -> float`` fitness for :func:`repro.core.explore`'s
    ``objective`` hook (picklable arguments, so campaigns can ship the
    weights to pool workers and rebuild the closure there)."""
    def objective(d: DesignPoint) -> float:
        return Objectives.from_design(d).scalarize(weights)
    return objective
