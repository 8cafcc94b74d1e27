"""Campaign backends: one accelerator family == one backend.

DNNExplorer's claim is a *dynamic* design space that adapts to "different
combinations of DNN workloads and targeted FPGAs"; this module widens
"targeted FPGAs" to *targeted device families*. A :class:`Backend` bundles
everything :func:`repro.dse.campaign.run_campaign` needs to sweep one
family:

* an **objective schema** (:class:`repro.dse.objectives.ObjectiveSpec`
  tuple + default scalarization weights) — Pareto dominance, crowding
  diversity, ranking, and reports all derive from it generically;
* **cell expansion** — the cross product of that family's campaign axes
  into picklable cell dataclasses with stable ``.key`` strings;
* **cell evaluation** — ``run_cell(cell) -> store record``, the unit the
  process pool fans out and the JSONL store memoizes;
* a **search config** dict stored per record and compared on resume, so a
  store never silently serves results found under different settings;
* presentation/CLI hooks (table rows, progress headlines, axis flags).

Three backends ship:

``fpga``
    The paper's flow, byte-compatible with PR-1 stores: cells are
    (net x input x FPGA x precision x batch cap), each evaluated by a full
    PSO :func:`repro.core.explore`; records carry no ``backend`` field so
    existing stores resume unchanged.

``tpu``
    The beyond-paper retarget: cells are (arch x shape x chip count x
    remat x microbatches), each evaluated by enumerating the power-of-two
    (dp, tp) factorizations of the chip count through
    :func:`repro.core.tpu_planner.evaluate_point` and keeping the best
    mapping under the cell's scalarization. Objectives: step time, MFU,
    per-chip HBM (with the HBM-fit feasibility gate), chips used.

``cuda``
    The same retarget over the GPU roofline
    (:mod:`repro.core.gpu_model` / :mod:`repro.core.gpu_planner`): cells
    add a GPU-part axis (a100-40g / a100-80g / h100) on top of the TPU
    backend's workload axes, and the (dp, tp) search inside each cell is
    identical in shape. Objectives mirror the TPU vector plus board
    watts (GPU parts differ in TDP at the same count, so power is a real
    trade-off axis within the family).

Every backend can additionally express any of its records in the
*normalized* cross-backend schema
(:data:`repro.dse.objectives.NORMALIZED_OBJECTIVES` — delivered TFLOP/s,
per watt, per dollar-proxy, per peak TFLOP) via :meth:`Backend.normalized`
— computed from stored objectives at read time, so pre-existing stores
compare across device families without re-running anything.
"""
from __future__ import annotations

import abc
import argparse
import dataclasses
import os
import time
from typing import Mapping, Sequence

from repro_torch.configs import ARCH_IDS, SHAPES, cell_enabled, get_config
from repro_torch.core import gpu_planner
from repro_torch.core.explorer import TRACE_SCHEMA_VERSION
from repro_torch.core.hw_specs import FPGAS, GPUS, TPU_V5E, alpha_for, pod_cost
from repro_torch.core.netinfo import TABLE1_NETS
from repro_torch.core.tpu_planner import evaluate_point, factorizations

from .objectives import (DEFAULT_WEIGHTS, OBJECTIVES, ObjectiveSpec,
                         canonical_vector, normalized_throughput,
                         scalarize_values)
from .store import SCHEMA_VERSION

#: Kept as a local literal (matches :data:`repro.testing.faults.ENV_VAR`)
#: so the disabled-harness hot path never imports repro.testing.
_FAULTS_ENV = "REPRO_FAULTS"


# ---------------------------------------------------------------------------
# CLI axis parsing (shared by both backends; re-exported by repro.dse.cli)
# ---------------------------------------------------------------------------


def _csv(text: str) -> list[str]:
    return [t.strip() for t in text.split(",") if t.strip()]


def parse_inputs(text: str) -> list[tuple[int, int]]:
    """``"224,320x480"`` -> ``[(224, 224), (320, 480)]``."""
    out = []
    for tok in _csv(text):
        h, _, w = tok.partition("x")
        try:
            out.append((int(h), int(w or h)))
        except ValueError:
            raise ValueError(
                f"bad input size {tok!r}; expected H or HxW "
                f"(e.g. 224 or 320x480)") from None
    return out


def parse_searcher_config(text: str) -> dict | None:
    """``"screen=2048,survivors=8"`` -> engine-config override dict (None
    if empty). Values coerce to int, then float, else stay strings, so
    the stored search config is JSON-stable regardless of whether it
    came from the CLI or a programmatic call."""
    if not text:
        return None
    out: dict = {}
    for tok in _csv(text):
        name, sep, val = (part.strip() for part in tok.partition("="))
        if not name or not sep:
            raise ValueError(f"bad searcher-config token {tok!r}; "
                             f"expected name=value")
        try:
            out[name] = int(val)
        except ValueError:
            try:
                out[name] = float(val)
            except ValueError:
                out[name] = val
    return out


def parse_weights(text: str) -> dict[str, float] | None:
    """``"throughput_ips=1,dsp_eff=500"`` -> weight dict (None if empty).
    A bare ``name`` or ``name=`` means weight 1.0."""
    if not text:
        return None
    out = {}
    for tok in _csv(text):
        name, _, val = (part.strip() for part in tok.partition("="))
        if not name:
            raise ValueError(f"bad weight token {tok!r}; "
                             f"expected name=value")
        try:
            out[name] = float(val) if val else 1.0
        except ValueError:
            raise ValueError(f"bad weight value in {tok!r}; "
                             f"expected a number after '='") from None
    return out


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------


class Backend(abc.ABC):
    """One device family's campaign contract (see module docstring)."""

    name: str
    objectives: tuple[ObjectiveSpec, ...]
    default_weights: Mapping[str, float]
    default_store: str
    #: Whether ``--searcher`` applies: True only for backends whose cells
    #: run a pluggable search engine (fpga); exhaustive enumerators
    #: (tpu, cuda) reject any non-default engine up front.
    supports_searchers: bool = False

    # -- objective-vector helpers (schema-generic, shared) ------------------

    def objective_names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.objectives)

    def canonical(self, objectives: Mapping[str, float]) -> tuple[float, ...]:
        """A record's ``objectives`` dict -> maximization-form vector."""
        return canonical_vector(objectives, self.objectives)

    def scalarize(self, objectives: Mapping,
                  weights: Mapping[str, float] | None = None) -> float:
        """Weighted canonical sum; infeasible records score 0.0."""
        return scalarize_values(objectives, self.objectives, weights,
                                self.default_weights)

    @abc.abstractmethod
    def normalized(self, rec: Mapping) -> dict:
        """A store record's objectives re-expressed in the cross-backend
        :data:`~repro.dse.objectives.NORMALIZED_OBJECTIVES` schema
        (delivered TFLOP/s, per watt, per dollar-proxy, per peak TFLOP).
        Computed from the STORED objectives + the hardware tables, not
        re-evaluated — legacy stores normalize without re-running."""

    # -- campaign contract ---------------------------------------------------

    @abc.abstractmethod
    def expand_cells(self, **axes) -> list:
        """Cross product of this backend's campaign axes -> cell list."""

    @abc.abstractmethod
    def run_cell(self, cell, *, base_seed: int = 0, population: int = 20,
                 iterations: int = 30,
                 weights: Mapping[str, float] | None = None,
                 searcher: str = "pso",
                 searcher_config: Mapping | None = None,
                 calibration=None) -> dict:
        """Evaluate ONE cell -> a JSONL store record. ``searcher`` /
        ``searcher_config`` select the engine on backends that search
        (ignored by exhaustive enumerators, which accept only the
        default — :func:`repro.dse.campaign.run_campaign` rejects the
        rest up front). ``calibration`` (a
        :class:`repro.calib.Calibration`) rescales the cell's hardware
        spec to measured delivered rates before evaluation and stamps a
        ``calibration`` provenance block on the record; ``None`` / the
        identity calibration evaluate byte-identically to pre-calibration
        behavior."""

    @abc.abstractmethod
    def search_config(self, *, base_seed: int, population: int,
                      iterations: int,
                      weights: Mapping[str, float] | None,
                      searcher: str = "pso",
                      searcher_config: Mapping | None = None,
                      calibration=None) -> dict:
        """The settings a record was searched with (resume-match key).
        A non-identity ``calibration`` contributes its fingerprint, so a
        store searched under one set of correction factors never silently
        serves a campaign run under another; identity contributes nothing
        (legacy stores resume byte-for-byte)."""

    # -- presentation --------------------------------------------------------

    @abc.abstractmethod
    def headline(self, rec: dict) -> str:
        """One-line progress metric for a finished cell."""

    @abc.abstractmethod
    def group_key(self, rec: dict) -> str:
        """Workload grouping for per-cell-winner report tables. Also the
        *workload key* :mod:`repro.dse.placement` matches candidates on —
        the TPU and CUDA backends share the ``arch/shape`` key space on
        purpose, so one workload can be hosted by either family."""

    # -- placement hooks (repro.dse.placement) -------------------------------

    @abc.abstractmethod
    def record_cost(self, rec: Mapping) -> tuple[float, float]:
        """(watts, usd_per_hour) of the hardware a stored design occupies,
        from the ``hw_specs`` TDP/$ tables — the budget currency of
        :mod:`repro.dse.placement`."""

    @abc.abstractmethod
    def placement_point(self, rec: Mapping) -> dict:
        """``{part, count, point}`` describing the assigned hardware: the
        named part, how many of it, and the intra-cell design point the
        search picked (FPGA: the RAV split; TPU/CUDA: the dp x tp mesh)."""

    @abc.abstractmethod
    def coverage_cells(self, workload_key: str) -> list:
        """Default campaign cells for ONE workload key (the coverage-query
        hook): when a placement store has no candidates for a workload,
        these cells are what :mod:`repro.dse.placement` evaluates to fill
        the gap. Returns [] for keys this backend cannot host."""

    @abc.abstractmethod
    def table_header(self) -> str: ...

    @abc.abstractmethod
    def table_row(self, rec: dict) -> str: ...

    # -- CLI -----------------------------------------------------------------

    @abc.abstractmethod
    def add_axis_arguments(self, ap) -> None:
        """Register this backend's campaign-axis flags on the parser."""

    @abc.abstractmethod
    def cells_from_args(self, args) -> list:
        """Parsed argparse namespace -> expanded cell list."""


# ---------------------------------------------------------------------------
# fpga — the paper's flow (byte-compatible with PR-1 stores)
# ---------------------------------------------------------------------------


class FPGABackend(Backend):
    """DNNExplorer's own design space: one PSO search per campaign cell.

    Thin delegation onto :mod:`repro.dse.campaign`'s original module-level
    functions (imported lazily; campaign imports this module's registry).
    Records and search configs are IDENTICAL to what PR 1 wrote, so
    pre-existing stores resume with zero re-evaluation. Since PR 5 each
    cell's PSO population is evaluated through the batched array-kernel
    engine (:mod:`repro.core.batch_eval`, wired inside
    :func:`repro.core.explore`) — same designs, ~an order of magnitude
    less analytical-model time per cell (the ``campaign_fpga`` bench
    measures both paths in one run).

    The only backend with a pluggable per-cell search engine
    (``supports_searchers``): ``--searcher`` picks from the
    :data:`repro.core.search.SEARCHERS` registry (default: the paper's
    PSO) and ``--searcher-config`` overrides that engine's config —
    see ``docs/search.md``. The other backends enumerate their mapping
    spaces exhaustively and reject the flags.
    """

    name = "fpga"
    objectives = OBJECTIVES
    default_weights = DEFAULT_WEIGHTS
    default_store = "results/dse_campaign.jsonl"
    supports_searchers = True

    def expand_cells(self, *, nets: Sequence[str],
                     inputs: Sequence[tuple[int, int]],
                     fpgas: Sequence[str], precisions: Sequence[int],
                     batch_caps: Sequence[int]) -> list:
        from .campaign import expand_cells
        return expand_cells(nets, inputs, fpgas, precisions, batch_caps)

    def run_cell(self, cell, *, base_seed=0, population=20, iterations=30,
                 weights=None, searcher="pso", searcher_config=None,
                 screen_fits=None, calibration=None) -> dict:
        from .campaign import run_cell
        return run_cell(cell, base_seed, population, iterations, weights,
                        searcher, searcher_config, screen_fits,
                        calibration=calibration)

    def search_config(self, *, base_seed, population, iterations,
                      weights, searcher="pso", searcher_config=None,
                      calibration=None) -> dict:
        from .campaign import _search_config
        return _search_config(base_seed, population, iterations, weights,
                              searcher, searcher_config,
                              calibration=calibration)

    def normalized(self, rec: Mapping) -> dict:
        """GOP/s -> TFLOP/s against the board's power/price and the
        precision-dependent DSP peak (Eq. 1) — ``tflops_per_peak`` is
        exactly the paper's DSP efficiency."""
        hw = FPGAS[rec["cell"]["fpga"]]
        o = rec["objectives"]
        peak_tflops = hw.peak_gops(alpha_for(rec["cell"]["precision"])) / 1e3
        return normalized_throughput(o["gops"] / 1e3, hw.tdp_watts,
                                     hw.usd_per_hour, peak_tflops,
                                     feasible=o.get("feasible", True))

    def record_cost(self, rec: Mapping) -> tuple[float, float]:
        """One board per design — the paper's accelerators are single-FPGA."""
        return pod_cost(FPGAS[rec["cell"]["fpga"]])

    def placement_point(self, rec: Mapping) -> dict:
        r = rec["rav"]
        return {"part": rec["cell"]["fpga"], "count": 1,
                "point": f"sp={r['sp']},b={r['batch']}"}

    def coverage_cells(self, workload_key: str) -> list:
        """``net@HxW`` / ``net@native`` -> one cell per FPGA part at the
        paper's default precision and batch cap."""
        from .campaign import RESIZABLE_NETS
        net, _, size = workload_key.partition("@")
        if net not in RESIZABLE_NETS and net not in TABLE1_NETS:
            return []
        inputs = [(0, 0)] if size in ("native", "") else parse_inputs(size)
        return self.expand_cells(nets=[net], inputs=inputs,
                                 fpgas=sorted(FPGAS), precisions=[16],
                                 batch_caps=[1])

    def headline(self, rec: dict) -> str:
        return f"{rec['objectives']['gops']:.1f} GOP/s"

    def group_key(self, rec: dict) -> str:
        c = rec["cell"]
        size = f"{c['h']}x{c['w']}" if c.get("h") else "native"
        return f"{c['net']}@{size}"

    def table_header(self) -> str:
        return (f"{'cell':<48} {'rav':<10} {'img/s':>8} {'GOP/s':>8} "
                f"{'lat_ms':>8} {'eff':>6} {'bram':>6}")

    def table_row(self, rec: dict) -> str:
        o, r = rec["objectives"], rec["rav"]
        return (f"{rec['cell_key']:<48} sp={r['sp']:>2} b={r['batch']:>2} "
                f"{o['throughput_ips']:>8.1f} {o['gops']:>8.1f} "
                f"{o['latency_s'] * 1e3:>8.2f} {o['dsp_eff']:>6.3f} "
                f"{int(o['bram_used']):>6}")

    def add_axis_arguments(self, ap) -> None:
        from .campaign import RESIZABLE_NETS
        g = ap.add_argument_group("fpga campaign axes")
        g.add_argument("--nets", default="vgg16",
                       help="comma list; resizable: %s; fixed: %s" % (
                           ",".join(RESIZABLE_NETS),
                           ",".join(n for n in TABLE1_NETS
                                    if n not in RESIZABLE_NETS)))
        g.add_argument("--inputs", default="224",
                       help="comma list of H or HxW for resizable nets")
        g.add_argument("--fpgas", default="ku115",
                       help="comma list from: " + ",".join(sorted(FPGAS)))
        g.add_argument("--precisions", default="16",
                       help="comma list of bit-widths (data == weights)")
        g.add_argument("--batch-caps", default="1",
                       help="comma list of PSO batch upper bounds")

    def cells_from_args(self, args) -> list:
        return self.expand_cells(
            nets=_csv(args.nets), inputs=parse_inputs(args.inputs),
            fpgas=_csv(args.fpgas),
            precisions=[int(p) for p in _csv(args.precisions)],
            batch_caps=[int(b) for b in _csv(args.batch_caps)])


# ---------------------------------------------------------------------------
# shared workload axes (tpu + cuda both sweep arch x shape x remat x mb)
# ---------------------------------------------------------------------------


def _add_once(group, *args, **kw) -> None:
    try:
        group.add_argument(*args, **kw)
    except argparse.ArgumentError:
        pass  # a sibling backend already registered this flag


def add_workload_arguments(ap) -> None:
    """Register the workload axes the TPU and CUDA backends share
    (``--archs/--shapes/--remats/--microbatches``). One CLI registers
    every backend's flags, so double registration must be a no-op."""
    g = ap.add_argument_group("workload axes (tpu & cuda backends)")
    _add_once(g, "--archs", default="starcoder2-3b",
              help="comma list from: " + ",".join(ARCH_IDS))
    _add_once(g, "--shapes", default="train_4k,decode_32k",
              help="comma list from: " + ",".join(SHAPES))
    _add_once(g, "--remats", default="full,dots,none",
              help="comma list of remat policies (train shapes)")
    _add_once(g, "--microbatches", default="1,2,4",
              help="comma list of microbatch counts (train shapes)")


#: Device-count budgets swept when placement must fill store coverage for
#: a workload (the tpu/cuda ``coverage_cells`` default axis).
PLACEMENT_COUNTS: tuple[int, ...] = (8, 16, 32)


def enumeration_trace(evaluated: int) -> dict:
    """Per-cell ``trace`` dict for an exhaustively-enumerated search
    (tpu/cuda): the whole mapping space is always visited, so the stop
    reason is ``"exhaustive"`` — such cells are never iteration-capped
    and never "still improving". Shares the schema of the PSO trace
    (:meth:`repro.core.explorer.ExplorationResult.convergence_trace`),
    so health reports render both uniformly."""
    return {"schema": TRACE_SCHEMA_VERSION, "engine": "enumeration",
            "stop_reason": "exhaustive", "iterations": evaluated,
            "evaluations": evaluated, "cache_hits": 0}


def stamp_calibration(cfg: dict, calibration) -> dict:
    """Add a non-identity calibration's fingerprint to a search-config
    dict (the resume-match key). Identity / ``None`` add nothing, so
    uncalibrated search configs — and therefore every pre-calibration
    store — stay byte-identical."""
    if calibration is not None and not calibration.is_identity():
        cfg["calibration"] = calibration.fingerprint()
    return cfg


def _arch_shape(workload_key: str) -> tuple[str, str] | None:
    """``arch/shape`` workload key -> (arch, shape), or None if the key
    isn't in the tpu/cuda key space (both families share it by design)."""
    arch, sep, shape = workload_key.partition("/")
    if not sep or arch not in ARCH_IDS or shape not in SHAPES:
        return None
    return arch, shape


def workload_families(workload_key: str) -> tuple[str, ...]:
    """Which device families can host a workload key: ``arch/shape`` keys
    are shared by the tpu AND cuda backends (that overlap is what lets
    :mod:`repro.dse.placement` choose a family per workload); ``net@size``
    keys belong to the fpga backend. Unknown keys return ()."""
    if _arch_shape(workload_key) is not None:
        return ("tpu", "cuda")
    from .campaign import RESIZABLE_NETS
    net = workload_key.partition("@")[0]
    if net in RESIZABLE_NETS or net in TABLE1_NETS:
        return ("fpga",)
    return ()


# ---------------------------------------------------------------------------
# tpu — the beyond-paper retarget over repro.core.tpu_planner
# ---------------------------------------------------------------------------

#: TPU campaign objective vector, in report order. ``hbm_gib`` is the
#: per-chip HBM demand; the 90%-of-HBM fit check is the feasibility gate.
TPU_OBJECTIVES: tuple[ObjectiveSpec, ...] = (
    ObjectiveSpec("step_time_s", False, "s"),
    ObjectiveSpec("mfu", True, "frac"),
    ObjectiveSpec("hbm_gib", False, "GiB"),
    ObjectiveSpec("chips", False, "chips"),
)

#: Latency-first by default (the planner's own primary sort); campaigns
#: re-weight with e.g. ``mfu=1`` or ``chips=-...`` for efficiency sweeps.
TPU_DEFAULT_WEIGHTS: Mapping[str, float] = {"step_time_s": 1.0}


@dataclasses.dataclass(frozen=True)
class TPUCell:
    """One point of the TPU campaign grid: a (workload, mapping-budget)
    pair. The dp x tp factorization of ``chips`` is NOT an axis — it is
    searched inside the cell (the local step), mirroring how an FPGA cell
    searches its RAV inside :func:`repro.core.explore`."""

    arch: str
    shape: str
    chips: int
    remat: str
    microbatches: int

    @property
    def key(self) -> str:
        return (f"arch={self.arch}|shape={self.shape}|chips={self.chips}"
                f"|remat={self.remat}|mb={self.microbatches}")


class TPUBackend(Backend):
    """Sweep (arch x shape x chips x remat x microbatches) through the
    analytic TPU planner; per cell, keep the best (dp, tp) mapping under
    the cell's scalarization (feasible mappings first)."""

    name = "tpu"
    objectives = TPU_OBJECTIVES
    default_weights = TPU_DEFAULT_WEIGHTS
    default_store = "results/dse_campaign_tpu.jsonl"

    def expand_cells(self, *, archs: Sequence[str], shapes: Sequence[str],
                     chips: Sequence[int],
                     remats: Sequence[str] = ("full", "dots", "none"),
                     microbatches: Sequence[int] = (1, 2, 4)) -> list[TPUCell]:
        """The TPU campaign grid. Remat and microbatching only exist for
        training shapes: inference shapes collapse those axes to
        ``(none, 1)`` and contribute one row per remaining axis. Cells the
        spec disables (e.g. full attention at 500k context) are skipped."""
        for s in shapes:
            if s not in SHAPES:
                raise KeyError(f"unknown shape {s!r}; known: {sorted(SHAPES)}")
        for c in chips:
            if c <= 0 or c & (c - 1):
                raise ValueError(f"chips must be a positive power of two "
                                 f"(got {c}); the planner factorizes the "
                                 f"mesh into power-of-two dp x tp ways")
        for r in remats:
            if r not in ("full", "dots", "none"):
                raise ValueError(f"unknown remat policy {r!r}; "
                                 f"choose from full, dots, none")
        cells, seen = [], set()
        for arch in archs:
            cfg = get_config(arch)  # raises KeyError on unknown arch
            for shape_name in shapes:
                shape = SHAPES[shape_name]
                enabled, _why = cell_enabled(cfg, shape)
                if not enabled:
                    continue
                train = shape.kind == "train"
                for n in chips:
                    for remat in (remats if train else ("none",)):
                        for mb in (microbatches if train else (1,)):
                            cell = TPUCell(arch, shape_name, n, remat, mb)
                            if cell.key not in seen:
                                seen.add(cell.key)
                                cells.append(cell)
        return cells

    def run_cell(self, cell: TPUCell, *, base_seed=0, population=20,
                 iterations=30, weights=None, searcher="pso",
                 searcher_config=None, calibration=None) -> dict:
        """Enumerate the (dp, tp) factorizations of the cell's chip count;
        keep the best mapping: feasible first, then highest scalarized
        objective (ties to the earlier factorization — smaller tp)."""
        t0 = time.perf_counter()
        cfg = get_config(cell.arch)
        shape = SHAPES[cell.shape]
        best, best_rank, evaluated = None, None, 0
        for dp, tp in factorizations(cell.chips):
            if shape.global_batch % dp:
                continue
            plan = evaluate_point(cfg, shape, cell.chips, dp, tp,
                                  cell.remat, cell.microbatches,
                                  calibration=calibration)
            evaluated += 1
            obj = self._plan_objectives(cell, plan)
            # rank ignoring the feasibility gate (an all-infeasible cell
            # still reports its least-bad mapping), feasible plans first
            raw = scalarize_values({**obj, "feasible": True},
                                   self.objectives, weights,
                                   self.default_weights)
            rank = (plan.fits, raw)
            if best_rank is None or rank > best_rank:
                best, best_rank = (plan, obj), rank
        if best is None:
            raise ValueError(f"no valid dp x tp factorization for {cell.key} "
                             f"(global_batch={shape.global_batch})")
        plan, obj = best
        rec = {
            "schema": SCHEMA_VERSION,
            "backend": self.name,
            "cell_key": cell.key,
            "cell": dataclasses.asdict(cell),
            "arch_name": cfg.name,
            "search": self.search_config(base_seed=base_seed,
                                         population=population,
                                         iterations=iterations,
                                         weights=weights,
                                         calibration=calibration),
            "plan": {"dp": plan.dp, "tp": plan.tp,
                     "bound": plan.roofline.bound},
            "objectives": obj,
            "fitness": self.scalarize(obj, weights),
            "evaluations": evaluated,
            "search_time_s": round(time.perf_counter() - t0, 4),
            "weights": dict(weights) if weights else None,
            "trace": enumeration_trace(evaluated),
        }
        info = calibration.record_info(TPU_V5E.name) if calibration else None
        if info:
            rec["calibration"] = info
        return rec

    @staticmethod
    def _plan_objectives(cell: TPUCell, plan) -> dict:
        return {
            "step_time_s": plan.predicted_step_s,
            "mfu": plan.mfu,
            "hbm_gib": plan.hbm_per_chip / 2**30,
            "chips": float(cell.chips),
            "feasible": bool(plan.fits),
        }

    def search_config(self, *, base_seed, population, iterations,
                      weights, searcher="pso", searcher_config=None,
                      calibration=None) -> dict:
        """The planner enumerates its space exhaustively and
        deterministically, so search-engine knobs and seeds are
        irrelevant here; only the scalarization (which picks the
        per-cell mapping) and a non-identity calibration (which moves
        every modeled time) invalidate stored cells."""
        return stamp_calibration(
            {"weights": {k: float(v) for k, v in weights.items()}
             if weights else None}, calibration)

    def normalized(self, rec: Mapping) -> dict:
        """Delivered TFLOP/s from the stored MFU (useful FLOPs / step over
        the pod) against the pod's power/price/peak —
        ``tflops_per_peak`` is exactly the stored MFU."""
        o = rec["objectives"]
        hw = TPU_V5E
        chips = float(o["chips"])
        peak_tflops = chips * hw.peak_flops / 1e12
        return normalized_throughput(o["mfu"] * peak_tflops,
                                     chips * hw.tdp_watts,
                                     chips * hw.usd_per_hour, peak_tflops,
                                     feasible=o.get("feasible", True))

    def record_cost(self, rec: Mapping) -> tuple[float, float]:
        return pod_cost(TPU_V5E, int(rec["objectives"]["chips"]))

    def placement_point(self, rec: Mapping) -> dict:
        p = rec["plan"]
        return {"part": TPU_V5E.name, "count": int(rec["objectives"]["chips"]),
                "point": f"dp{p['dp']}xtp{p['tp']}"}

    def coverage_cells(self, workload_key: str) -> list:
        """``arch/shape`` -> that workload at every default chip budget."""
        parsed = _arch_shape(workload_key)
        if parsed is None:
            return []
        arch, shape = parsed
        return self.expand_cells(archs=[arch], shapes=[shape],
                                 chips=PLACEMENT_COUNTS)

    def headline(self, rec: dict) -> str:
        o = rec["objectives"]
        return (f"step={o['step_time_s']:.3g}s mfu={o['mfu']:.2f} "
                f"hbm={o['hbm_gib']:.1f}GiB")

    def group_key(self, rec: dict) -> str:
        c = rec["cell"]
        return f"{c['arch']}/{c['shape']}"

    def table_header(self) -> str:
        return (f"{'cell':<58} {'dpxtp':<8} {'step_s':>10} {'mfu':>6} "
                f"{'hbm_gib':>8} {'chips':>6} {'bound':<10}")

    def table_row(self, rec: dict) -> str:
        o, p = rec["objectives"], rec["plan"]
        return (f"{rec['cell_key']:<58} {p['dp']}x{p['tp']:<6} "
                f"{o['step_time_s']:>10.4g} {o['mfu']:>6.3f} "
                f"{o['hbm_gib']:>8.2f} {int(o['chips']):>6} {p['bound']:<10}")

    def add_axis_arguments(self, ap) -> None:
        add_workload_arguments(ap)
        g = ap.add_argument_group("tpu campaign axes")
        g.add_argument("--chips", default="8,16,32",
                       help="comma list of chip counts (powers of two)")

    def cells_from_args(self, args) -> list[TPUCell]:
        return self.expand_cells(
            archs=_csv(args.archs), shapes=_csv(args.shapes),
            chips=[int(c) for c in _csv(args.chips)],
            remats=tuple(_csv(args.remats)),
            microbatches=tuple(int(m) for m in _csv(args.microbatches)))


# ---------------------------------------------------------------------------
# cuda — the GPU roofline retarget over repro.core.gpu_planner
# ---------------------------------------------------------------------------

#: CUDA campaign objective vector, in report order. Mirrors the TPU
#: vector, plus board watts: the GPU-part axis makes power a real
#: trade-off WITHIN the family (an H100 pod beats an A100 pod on step
#: time at the same count but burns 1.75x the board power).
GPU_OBJECTIVES: tuple[ObjectiveSpec, ...] = (
    ObjectiveSpec("step_time_s", False, "s"),
    ObjectiveSpec("mfu", True, "frac"),
    ObjectiveSpec("hbm_gib", False, "GiB"),
    ObjectiveSpec("gpus", False, "gpus"),
    ObjectiveSpec("watts", False, "W"),
)

#: Latency-first by default, same as the TPU backend.
GPU_DEFAULT_WEIGHTS: Mapping[str, float] = {"step_time_s": 1.0}


@dataclasses.dataclass(frozen=True)
class CUDACell:
    """One point of the CUDA campaign grid: a (workload, GPU part,
    GPU-count budget) triple. As on the TPU side, the dp x tp
    factorization of ``gpus`` is searched INSIDE the cell."""

    arch: str
    shape: str
    gpu: str             # GPUSpec name (a100-40g, a100-80g, h100)
    gpus: int
    remat: str
    microbatches: int

    @property
    def key(self) -> str:
        return (f"arch={self.arch}|shape={self.shape}|gpu={self.gpu}"
                f"|gpus={self.gpus}|remat={self.remat}"
                f"|mb={self.microbatches}")


class CUDABackend(Backend):
    """Sweep (arch x shape x GPU part x GPU count x remat x microbatches)
    through the analytic GPU roofline; per cell, keep the best (dp, tp)
    mapping under the cell's scalarization (feasible mappings first)."""

    name = "cuda"
    objectives = GPU_OBJECTIVES
    default_weights = GPU_DEFAULT_WEIGHTS
    default_store = "results/dse_campaign_cuda.jsonl"

    def expand_cells(self, *, archs: Sequence[str], shapes: Sequence[str],
                     gpus: Sequence[int],
                     gpu_types: Sequence[str] = ("a100-80g",),
                     remats: Sequence[str] = ("full", "dots", "none"),
                     microbatches: Sequence[int] = (1, 2, 4),
                     ) -> list[CUDACell]:
        """The CUDA campaign grid: the TPU backend's workload axes crossed
        with the GPU-part axis. Inference shapes collapse (remat, mb) to
        ``(none, 1)``; spec-disabled (arch, shape) combos are skipped."""
        for s in shapes:
            if s not in SHAPES:
                raise KeyError(f"unknown shape {s!r}; known: {sorted(SHAPES)}")
        for g in gpu_types:
            if g not in GPUS:
                raise KeyError(f"unknown gpu {g!r}; known: {sorted(GPUS)}")
        for n in gpus:
            if n <= 0 or n & (n - 1):
                raise ValueError(f"gpus must be a positive power of two "
                                 f"(got {n}); the planner factorizes the "
                                 f"mesh into power-of-two dp x tp ways")
        for r in remats:
            if r not in ("full", "dots", "none"):
                raise ValueError(f"unknown remat policy {r!r}; "
                                 f"choose from full, dots, none")
        cells, seen = [], set()
        for arch in archs:
            cfg = get_config(arch)  # raises KeyError on unknown arch
            for shape_name in shapes:
                shape = SHAPES[shape_name]
                enabled, _why = cell_enabled(cfg, shape)
                if not enabled:
                    continue
                train = shape.kind == "train"
                for gpu in gpu_types:
                    for n in gpus:
                        for remat in (remats if train else ("none",)):
                            for mb in (microbatches if train else (1,)):
                                cell = CUDACell(arch, shape_name, gpu, n,
                                                remat, mb)
                                if cell.key not in seen:
                                    seen.add(cell.key)
                                    cells.append(cell)
        return cells

    def run_cell(self, cell: CUDACell, *, base_seed=0, population=20,
                 iterations=30, weights=None, searcher="pso",
                 searcher_config=None, calibration=None) -> dict:
        """Enumerate the (dp, tp) factorizations of the cell's GPU count
        on the cell's part; keep the best mapping: feasible first, then
        highest scalarized objective (ties to the smaller tp)."""
        t0 = time.perf_counter()
        cfg = get_config(cell.arch)
        shape = SHAPES[cell.shape]
        hw = GPUS[cell.gpu]
        best, best_rank, evaluated = None, None, 0
        for dp, tp in factorizations(cell.gpus):
            if shape.global_batch % dp:
                continue
            plan = gpu_planner.evaluate_point(cfg, shape, cell.gpus, dp, tp,
                                              cell.remat, cell.microbatches,
                                              hw, calibration=calibration)
            evaluated += 1
            obj = self._plan_objectives(cell, plan, hw)
            # rank ignoring the feasibility gate (an all-infeasible cell
            # still reports its least-bad mapping), feasible plans first
            raw = scalarize_values({**obj, "feasible": True},
                                   self.objectives, weights,
                                   self.default_weights)
            rank = (plan.fits, raw)
            if best_rank is None or rank > best_rank:
                best, best_rank = (plan, obj), rank
        if best is None:
            raise ValueError(f"no valid dp x tp factorization for {cell.key} "
                             f"(global_batch={shape.global_batch})")
        plan, obj = best
        rec = {
            "schema": SCHEMA_VERSION,
            "backend": self.name,
            "cell_key": cell.key,
            "cell": dataclasses.asdict(cell),
            "arch_name": cfg.name,
            "search": self.search_config(base_seed=base_seed,
                                         population=population,
                                         iterations=iterations,
                                         weights=weights,
                                         calibration=calibration),
            "plan": {"dp": plan.dp, "tp": plan.tp,
                     "bound": plan.roofline.bound},
            "objectives": obj,
            "fitness": self.scalarize(obj, weights),
            "evaluations": evaluated,
            "search_time_s": round(time.perf_counter() - t0, 4),
            "weights": dict(weights) if weights else None,
            "trace": enumeration_trace(evaluated),
        }
        info = calibration.record_info(cell.gpu) if calibration else None
        if info:
            rec["calibration"] = info
        return rec

    @staticmethod
    def _plan_objectives(cell: CUDACell, plan, hw) -> dict:
        return {
            "step_time_s": plan.predicted_step_s,
            "mfu": plan.mfu,
            "hbm_gib": plan.hbm_per_gpu / 2**30,
            "gpus": float(cell.gpus),
            "watts": cell.gpus * hw.tdp_watts,
            "feasible": bool(plan.fits),
        }

    def search_config(self, *, base_seed, population, iterations,
                      weights, searcher="pso", searcher_config=None,
                      calibration=None) -> dict:
        """Deterministic exhaustive enumeration, like the TPU backend:
        only the scalarization (which picks the per-cell mapping) and a
        non-identity calibration invalidate stored cells."""
        return stamp_calibration(
            {"weights": {k: float(v) for k, v in weights.items()}
             if weights else None}, calibration)

    def normalized(self, rec: Mapping) -> dict:
        """Delivered TFLOP/s from the stored MFU against the pod's
        power/price/peak for the cell's GPU part."""
        o = rec["objectives"]
        hw = GPUS[rec["cell"]["gpu"]]
        n = float(o["gpus"])
        peak_tflops = n * hw.peak_flops / 1e12
        return normalized_throughput(o["mfu"] * peak_tflops, o["watts"],
                                     n * hw.usd_per_hour, peak_tflops,
                                     feasible=o.get("feasible", True))

    def record_cost(self, rec: Mapping) -> tuple[float, float]:
        return pod_cost(GPUS[rec["cell"]["gpu"]],
                        int(rec["objectives"]["gpus"]))

    def placement_point(self, rec: Mapping) -> dict:
        p = rec["plan"]
        return {"part": rec["cell"]["gpu"],
                "count": int(rec["objectives"]["gpus"]),
                "point": f"dp{p['dp']}xtp{p['tp']}"}

    def coverage_cells(self, workload_key: str) -> list:
        """``arch/shape`` -> that workload at every default GPU-count
        budget, across every part in the GPU table."""
        parsed = _arch_shape(workload_key)
        if parsed is None:
            return []
        arch, shape = parsed
        return self.expand_cells(archs=[arch], shapes=[shape],
                                 gpus=PLACEMENT_COUNTS,
                                 gpu_types=tuple(sorted(GPUS)))

    def headline(self, rec: dict) -> str:
        o = rec["objectives"]
        return (f"step={o['step_time_s']:.3g}s mfu={o['mfu']:.2f} "
                f"hbm={o['hbm_gib']:.1f}GiB {int(o['watts'])}W")

    def group_key(self, rec: dict) -> str:
        c = rec["cell"]
        return f"{c['arch']}/{c['shape']}"

    def table_header(self) -> str:
        return (f"{'cell':<64} {'dpxtp':<8} {'step_s':>10} {'mfu':>6} "
                f"{'hbm_gib':>8} {'gpus':>5} {'watts':>7} {'bound':<10}")

    def table_row(self, rec: dict) -> str:
        o, p = rec["objectives"], rec["plan"]
        return (f"{rec['cell_key']:<64} {p['dp']}x{p['tp']:<6} "
                f"{o['step_time_s']:>10.4g} {o['mfu']:>6.3f} "
                f"{o['hbm_gib']:>8.2f} {int(o['gpus']):>5} "
                f"{int(o['watts']):>7} {p['bound']:<10}")

    def add_axis_arguments(self, ap) -> None:
        add_workload_arguments(ap)
        g = ap.add_argument_group("cuda campaign axes")
        g.add_argument("--gpus", default="8,16,32",
                       help="comma list of GPU counts (powers of two)")
        g.add_argument("--gpu-types", default="a100-80g",
                       help="comma list from: " + ",".join(sorted(GPUS)))

    def cells_from_args(self, args) -> list[CUDACell]:
        return self.expand_cells(
            archs=_csv(args.archs), shapes=_csv(args.shapes),
            gpus=[int(n) for n in _csv(args.gpus)],
            gpu_types=tuple(_csv(args.gpu_types)),
            remats=tuple(_csv(args.remats)),
            microbatches=tuple(int(m) for m in _csv(args.microbatches)))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

BACKENDS: dict[str, Backend] = {b.name: b for b in (FPGABackend(),
                                                    TPUBackend(),
                                                    CUDABackend())}


def get_backend(backend: str | Backend) -> Backend:
    """Resolve a backend by name (or pass an instance through)."""
    if isinstance(backend, Backend):
        return backend
    try:
        return BACKENDS[backend]
    except KeyError:
        raise KeyError(f"unknown backend {backend!r}; "
                       f"known: {sorted(BACKENDS)}") from None


def record_backend(rec: Mapping) -> str:
    """Which backend wrote a store record. Legacy (PR-1) FPGA records
    predate the field and carry no ``backend`` key."""
    return rec.get("backend", "fpga")


def run_cell_by_backend(backend_name: str, cell, base_seed: int,
                        population: int, iterations: int,
                        weights: Mapping[str, float] | None,
                        obs: Mapping | None = None,
                        searcher: str = "pso",
                        searcher_config: Mapping | None = None,
                        screen_fits=None, calibration=None,
                        attempt: int = 1, faults=None) -> dict:
    """Top-level (picklable) pool entry point: resolve the backend by name
    in the worker and evaluate one cell.

    ``obs`` (``{events_dir, t_submit}``) turns on worker-side telemetry:
    the worker opens its own sidecar under ``events_dir``
    (:func:`repro.obs.worker_tracer`), back-fills a ``queue.wait`` span
    from the parent's submit time, nests a ``cell.eval`` span inside
    ``cell.run``, and gauges the batched engine's cache stats — the
    parent merges every sidecar after the pool drains. ``obs=None`` (the
    default, and the disabled-tracing path) touches no files.

    ``screen_fits`` forwards the cell's precomputed rung-0 screening
    fitnesses (:func:`repro_torch.dse.campaign.prescreen_cells`) and is
    only ever non-None for the fpga backend — the exhaustive
    enumerators never see the keyword. ``calibration`` (picklable)
    forwards the campaign's correction factors into the worker.

    ``attempt`` is the 1-based retry attempt the resilience layer is on
    — workers are stateless across retries, so the attempt number rides
    in. ``faults`` arms the deterministic fault-injection harness
    (:mod:`repro.testing.faults`): a plan path/dict/FaultPlan, defaulting
    to the ``REPRO_FAULTS`` env var (inherited by spawn workers). Unset
    — the production case — the check is a single dict lookup and the
    harness module is never imported."""
    if faults is None:
        faults = os.environ.get(_FAULTS_ENV)
    plan = None
    if faults:
        from repro_torch.testing.faults import load_plan
        plan = load_plan(faults)
        plan.fire_before(cell.key, attempt)
    be = get_backend(backend_name)
    kw = {} if screen_fits is None else {"screen_fits": screen_fits}
    if not obs:
        rec = be.run_cell(cell, base_seed=base_seed, population=population,
                          iterations=iterations, weights=weights,
                          searcher=searcher,
                          searcher_config=searcher_config,
                          calibration=calibration, **kw)
        return plan.mangle_after(cell.key, attempt, rec) if plan else rec
    from repro_torch.obs import worker_tracer
    with worker_tracer(obs["events_dir"]) as tracer:
        tracer.span_at("queue.wait", obs["t_submit"],
                       time.time() - obs["t_submit"], cell=cell.key)
        with tracer.span("cell.run", cell=cell.key, backend=backend_name):
            with tracer.span("cell.eval", cell=cell.key):
                rec = be.run_cell(cell, base_seed=base_seed,
                                  population=population,
                                  iterations=iterations, weights=weights,
                                  searcher=searcher,
                                  searcher_config=searcher_config,
                                  calibration=calibration, **kw)
            if backend_name == "fpga":
                from repro_torch.core.batch_eval import cache_stats
                for cache, st in cache_stats().items():
                    tracer.gauge(f"cache.{cache}.hits", st["hits"],
                                 cell=cell.key)
                    tracer.gauge(f"cache.{cache}.misses", st["misses"],
                                 cell=cell.key)
    return plan.mangle_after(cell.key, attempt, rec) if plan else rec
