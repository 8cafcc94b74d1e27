"""Campaign backends: one accelerator family == one backend.

The port's copy of ``repro/dse/backends.py``, cut to the backend this
slice ports. A :class:`Backend` bundles everything
:func:`repro_torch.dse.campaign.run_campaign` needs to sweep one family:
an objective schema, cell expansion, per-cell evaluation, a resume-match
search config, and presentation/CLI hooks. The code that is here is the
reference's, line for line.

``fpga``
    The paper's flow: cells are (net x input x FPGA x precision x batch
    cap), each evaluated by a full :func:`repro_torch.core.explore`;
    records carry no ``backend`` field, so the reference's stores resume
    unchanged in the port and the port's in the reference.

The ``tpu`` and ``cuda`` backends need the TPU and GPU planners
(``tpu_model``, ``tpu_planner``, ``gpu_model``, ``gpu_planner``), which are
not ported yet (``ROADMAP.md``, queue 1). :func:`get_backend` refuses them
by name, with that message, instead of running something else.
"""
from __future__ import annotations

import abc
import os
import time
from typing import Mapping, Sequence

from repro_torch.core.hw_specs import FPGAS, alpha_for, pod_cost
from repro_torch.core.netinfo import TABLE1_NETS

from .objectives import (DEFAULT_WEIGHTS, OBJECTIVES, ObjectiveSpec,
                         canonical_vector, normalized_throughput,
                         scalarize_values)

#: Kept as a local literal (matches :data:`repro.testing.faults.ENV_VAR`)
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


def stamp_calibration(cfg: dict, calibration) -> dict:
    """Add a non-identity calibration's fingerprint to a search-config
    dict (the resume-match key). Identity / ``None`` add nothing, so
    uncalibrated search configs — and therefore every pre-calibration
    store — stay byte-identical."""
    if calibration is not None and not calibration.is_identity():
        cfg["calibration"] = calibration.fingerprint()
    return cfg


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

BACKENDS: dict[str, Backend] = {b.name: b for b in (FPGABackend(),)}

#: Backends of the JAX package that the port does not have yet, and why.
UNPORTED_BACKENDS: dict[str, str] = {
    name: (f"backend {name!r} is not ported yet: it needs {deps}, which are "
           f"queued in ROADMAP.md (queue 1, item 13: the TPU and CUDA backends)")
    for name, deps in (("tpu", "core/tpu_model.py and core/tpu_planner.py"),
                       ("cuda", "core/gpu_model.py and core/gpu_planner.py"))}


def get_backend(backend: str | Backend) -> Backend:
    """Resolve a backend by name (or pass an instance through). A backend
    of :data:`UNPORTED_BACKENDS` raises ``NotImplementedError``."""
    if isinstance(backend, Backend):
        return backend
    if backend in UNPORTED_BACKENDS:
        raise NotImplementedError(UNPORTED_BACKENDS[backend])
    try:
        return BACKENDS[backend]
    except KeyError:
        raise KeyError(f"unknown backend {backend!r}; "
                       f"known: {sorted(BACKENDS)}") from None


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
