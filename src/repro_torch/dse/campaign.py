"""Campaign runner: a backend's campaign grid, one search per cell, fanned
out over a process pool.

Each *cell* is an independent single-workload exploration (FPGA: the whole
of :func:`repro.core.explore`; TPU: a mapping enumeration through
:mod:`repro.core.tpu_planner` — see :mod:`repro.dse.backends`), so
campaigns parallelize embarrassingly; the pool fans cells out and the
JSONL store collects them as they finish. FPGA seeds are derived per cell
from ``(base_seed, cell key)``, so a campaign's results are reproducible
regardless of worker count, completion order, or which cells a resumed run
still has to do.

The module-level grid/evaluation functions here (``expand_cells``,
``run_cell``, ...) are the FPGA backend's implementation — kept at module
level both for backward compatibility and so pool workers can pickle them.

The port's copy of ``repro/dse/campaign.py``. One thing differs: the
hyperband searcher's rung-0 screen of every cell runs in one cross-cell
call of :func:`repro_torch.core.screen.screen_cells` on a device
(:func:`prescreen_cells`, ``run_campaign(screen_device=)``), the card by
default, where the reference calls its jax screen and falls back to NumPy
without it. Nothing here falls back: a CUDA screen on a machine without
CUDA raises. The records are the reference's, field for field, and the
stored search config leaves the device out, so a store resumes across
devices and across the two packages.

Run as a module for the CLI::

    python -m repro_torch.dse.campaign --nets vgg16 --fpgas ku115,zcu102 \\
        --precisions 16,8 --searcher hyperband
    python -m repro_torch.dse.campaign --backend tpu --archs starcoder2-3b \\
        --shapes train_4k --chips 8,16
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Iterable, Mapping, Sequence

from repro_torch.core.explorer import explore
from repro_torch.core.hw_specs import FPGAS
from repro_torch.core.netinfo import NetInfo, TABLE1_NETS, vgg16, vgg19
from repro_torch.core.pso import PSOConfig
from repro_torch.obs import (NULL, Tracer, chrome_path_for, chrome_trace,
                       events_dir_for, events_path_for, merge_events)

from .frontier import FrontierIndex
from .objectives import Objectives, scalarized_objective
from .pareto import select_diverse
from .resilience import (RetryPolicy, execute_cell, interrupt_scope,
                         run_resilient_pool)
from .store import (SCHEMA_VERSION, CampaignStore, is_ok, open_store,
                    rav_hash, record_status)

if TYPE_CHECKING:  # pragma: no cover - circular-import-free type hints
    from .backends import Backend

#: Nets whose input resolution is a campaign axis (the paper's Fig. 1/9/10
#: sweep). Fixed-topology nets from Table 1 run at their native input.
RESIZABLE_NETS: dict[str, Callable[[int, int], NetInfo]] = {
    "vgg16": lambda h, w: vgg16(h, w),
    "vgg19": lambda h, w: vgg19(h, w, with_fc=False),
}


@dataclasses.dataclass(frozen=True)
class CampaignCell:
    """One point of the campaign grid. ``h == w == 0`` means the network's
    native input (fixed-topology nets)."""

    net: str
    h: int
    w: int
    fpga: str
    precision: int   # data & weight bits (the paper quantizes both together)
    batch_max: int

    @property
    def key(self) -> str:
        size = f"{self.h}x{self.w}" if self.h else "native"
        return (f"net={self.net}|in={size}|fpga={self.fpga}"
                f"|prec={self.precision}|bmax={self.batch_max}")


def build_net(name: str, h: int = 0, w: int = 0) -> NetInfo:
    if name in RESIZABLE_NETS:
        if h <= 0:
            h = w = 224
        return RESIZABLE_NETS[name](h, w)
    if name in TABLE1_NETS:
        return TABLE1_NETS[name]()
    known = sorted(set(RESIZABLE_NETS) | set(TABLE1_NETS))
    raise KeyError(f"unknown net {name!r}; known: {known}")


def expand_cells(nets: Sequence[str], inputs: Sequence[tuple[int, int]],
                 fpgas: Sequence[str], precisions: Sequence[int],
                 batch_caps: Sequence[int]) -> list[CampaignCell]:
    """The campaign grid. Input sizes multiply only the resizable nets;
    fixed nets contribute one (native-input) row per remaining axis."""
    for f in fpgas:
        if f not in FPGAS:
            raise KeyError(f"unknown fpga {f!r}; known: {sorted(FPGAS)}")
    cells = []
    for net in nets:
        sizes = list(inputs) if net in RESIZABLE_NETS else [(0, 0)]
        for h, w in sizes:
            for fpga in fpgas:
                for prec in precisions:
                    for bmax in batch_caps:
                        cells.append(CampaignCell(net, h, w, fpga, prec, bmax))
    return cells


def cell_seed(base_seed: int, cell: CampaignCell) -> int:
    """Deterministic PSO seed for one cell: stable across runs, worker
    counts, and cell orderings."""
    digest = hashlib.sha256(f"{base_seed}|{cell.key}".encode()).digest()
    return int.from_bytes(digest[:4], "big") & 0x7FFFFFFF


def _search_config(base_seed: int, population: int, iterations: int,
                   weights: Mapping[str, float] | None,
                   searcher: str = "pso",
                   searcher_config: Mapping | None = None,
                   calibration=None) -> dict:
    """What a record was searched *with*. Stored per record and compared on
    resume, so a store never silently serves results found under different
    search settings or objective weights — including a different search
    ENGINE: a store written by one engine resumed under another re-runs
    instead of mixing results. JSON-native values only (the dict must
    survive a json round trip unchanged). The ``searcher`` keys are only
    present when non-default, so PR-1 stores (written before engines were
    pluggable) still resume byte-for-byte under the default PSO; likewise
    a ``calibration`` key appears only for a non-identity calibration
    (its fingerprint — corrected and uncorrected results never mix)."""
    cfg = {"base_seed": int(base_seed), "population": int(population),
           "iterations": int(iterations),
           "weights": {k: float(v) for k, v in weights.items()} if weights
           else None}
    if searcher != "pso" or searcher_config:
        cfg["searcher"] = searcher
        cfg["searcher_config"] = dict(searcher_config) \
            if searcher_config else None
    from .backends import stamp_calibration
    return stamp_calibration(cfg, calibration)


def run_cell(cell: CampaignCell, base_seed: int = 0, population: int = 20,
             iterations: int = 30,
             weights: Mapping[str, float] | None = None,
             searcher: str = "pso",
             searcher_config: Mapping | None = None,
             screen_fits=None, calibration=None) -> dict:
    """One full explore() for one cell -> a store record. Top-level (and all
    arguments picklable) so ProcessPoolExecutor can ship it to workers.
    ``screen_fits`` optionally carries this cell's precomputed rung-0
    screening fitnesses (:func:`prescreen_cells`). ``calibration``
    (a :class:`repro_torch.calib.Calibration`) rescales the board's clock and
    bandwidth to measured delivered rates before the search — every
    evaluation inside :func:`repro.core.explore` (scalar reference and
    batched engine alike) then sees the corrected part."""
    net = build_net(cell.net, cell.h, cell.w)
    fpga = FPGAS[cell.fpga]
    if calibration is not None:
        fpga = calibration.for_spec(fpga)
    cfg = PSOConfig(population=population, iterations=iterations,
                    seed=cell_seed(base_seed, cell))
    res = explore(net, fpga, dw=cell.precision, ww=cell.precision,
                  batch_max=cell.batch_max, cfg=cfg,
                  objective=scalarized_objective(weights),
                  searcher=searcher, searcher_config=searcher_config,
                  screen_fits=screen_fits)
    d = res.design
    rec = {
        "schema": SCHEMA_VERSION,
        "cell_key": cell.key,
        "cell": dataclasses.asdict(cell),
        "net_name": net.name,
        "search": _search_config(base_seed, population, iterations, weights,
                                 searcher, searcher_config, calibration),
        "seed": cfg.seed,
        "rav": dataclasses.asdict(d.rav),
        "rav_hash": rav_hash(d.rav),
        "objectives": Objectives.from_design(d).as_dict(),
        "fitness": res.pso.best_fitness,
        "evaluations": res.pso.evaluations,
        "iterations": res.pso.iterations_run,
        "search_time_s": round(res.search_time_s, 4),
        "weights": dict(weights) if weights else None,
        "trace": res.convergence_trace(),
    }
    info = calibration.record_info(cell.fpga) if calibration else None
    if info:
        rec["calibration"] = info
    return rec


def prescreen_cells(cells: Sequence[CampaignCell], *,
                    base_seed: int = 0, population: int = 20,
                    iterations: int = 30,
                    searcher_config: Mapping | None = None,
                    calibration=None, device="cuda") -> dict:
    """Screen every cell's hyperband rung 0 in ONE call on ``device``.

    Reproduces each cell's :class:`~repro_torch.core.search.HyperbandConfig`
    through the same construction path the searcher uses
    (:func:`repro_torch.core.search.searcher_config_for`), generates the
    exact rung-0 position block the engine will ask for
    (:func:`repro_torch.core.search.hyperband_rung0`), and evaluates the
    whole (cells x screen) batch through the cross-cell screen
    (:func:`repro_torch.core.screen.screen_cells` — bit-identical to the
    per-cell NumPy reference). Returns ``{cell_key: (screen,) fitness
    array}`` to hand to :func:`run_cell` as ``screen_fits``. ``device``
    goes through :func:`repro_torch.device.resolve`: ``"cuda"`` without
    CUDA raises.
    """
    import numpy as np

    from repro_torch.core import screen
    from repro_torch.core.search import (SearchSpace, hyperband_rung0,
                                         searcher_config_for)
    tables, blocks, keys = [], [], []
    for cell in cells:
        net = build_net(cell.net, cell.h, cell.w)
        fpga = FPGAS[cell.fpga]
        if calibration is not None:
            # same corrected part run_cell will search, so the screening
            # fitnesses match the engine's own rung-0 evaluations
            fpga = calibration.for_spec(fpga)
        pso = PSOConfig(population=population, iterations=iterations,
                        seed=cell_seed(base_seed, cell))
        cfg = searcher_config_for(
            "hyperband",
            base=dict(population=pso.population, iterations=pso.iterations,
                      patience=pso.patience, seed=pso.seed),
            overrides=searcher_config)
        space = SearchSpace(sp_max=len(net.major_layers),
                            batch_max=cell.batch_max)
        blocks.append(hyperband_rung0(space, cfg))
        tables.append(screen.cell_tables(net, fpga, cell.precision,
                                         cell.precision))
        keys.append(cell.key)
    if not keys:
        return {}
    ips = screen.screen_cells(screen.stack_cells(tables), np.stack(blocks),
                              device=device)
    return {k: ips[i] for i, k in enumerate(keys)}


#: ``run_campaign``'s default ``screen_device``: the card for a hyperband
#: campaign of the fpga backend, no device screen otherwise.
_CARD_WHERE_IT_APPLIES = object()


@dataclasses.dataclass
class CampaignReport:
    cells: list                  # backend cells (CampaignCell, TPUCell, ...)
    records: list[dict]          # per cell in cell order; quarantined
    #                              (status "failed") records included,
    #                              cells interrupted before running absent
    reused_cells: int
    new_cells: int
    new_evaluations: int         # search evaluations actually run this time
    wall_time_s: float
    backend: "Backend | None" = None   # None == fpga (PR-1 compatibility)
    events_path: Path | None = None    # merged events JSONL (traced runs)
    trace_path: Path | None = None     # Chrome trace export (traced runs)
    failed_cells: int = 0        # quarantined records among `records`
    retried_cells: int = 0       # cells that succeeded after >= 1 retry
    missing_cells: int = 0       # requested cells with no record at all
    pool_rebuilds: int = 0       # worker-pool replacements (crash/timeout)
    interrupted: bool = False    # SIGINT/SIGTERM stopped the campaign

    def _backend(self) -> "Backend":
        if self.backend is None:
            from .backends import get_backend
            self.backend = get_backend("fpga")
        return self.backend

    @property
    def partial(self) -> bool:
        """True when the campaign did NOT deliver every requested cell as
        a normal result — interrupted, quarantined, or missing cells.
        The CLI exits 3 on partial campaigns (with a resume hint)."""
        return bool(self.interrupted or self.failed_cells
                    or self.missing_cells)

    def failures(self) -> list[dict]:
        """The quarantined (``status: "failed"``) records, cell order."""
        return [r for r in self.records if not is_ok(r)]

    def feasible(self) -> list[dict]:
        return [r for r in self.records
                if is_ok(r) and r.get("objectives", {}).get("feasible")]

    def frontier_index(self) -> FrontierIndex:
        """The campaign's incremental Pareto archive: feasible records
        streamed once into a :class:`repro.dse.frontier.FrontierIndex`
        (keys are feasible-record positions, payloads the records), built
        lazily and cached — :meth:`frontier` and the report generator
        read the front off this index instead of re-sorting the full
        record list."""
        if getattr(self, "_fi", None) is None:
            be = self._backend()
            fi = FrontierIndex()
            for i, r in enumerate(self.feasible()):
                fi.insert(i, be.canonical(r["objectives"]), payload=r)
            self._fi = fi
        return self._fi

    def ranked(self, weights: Mapping[str, float] | None = None) -> list[dict]:
        be = self._backend()
        recs = self.feasible()
        return sorted(recs, key=lambda r: be.scalarize(r["objectives"],
                                                       weights), reverse=True)

    def frontier(self, k: int | None = None) -> list[dict]:
        """Pareto-optimal designs across every feasible one in the campaign.

        ``k=None`` returns the whole first front in campaign-cell order
        (the original behavior). With ``k``, NSGA-II selection returns up
        to ``k`` designs ordered by (front rank, crowding distance): a
        SPREAD across the trade-off surface — extremes always included,
        clumps thinned — topped up from later fronts when the first front
        has fewer than ``k`` members.

        Both paths read the cached :meth:`frontier_index`; only ``k``
        larger than the first front falls back to the full NSGA-II sort
        (the incremental archive keeps front 0 only).
        """
        fi = self.frontier_index()
        if k is None:
            return [fi.payload(key) for key in fi.front_keys()]
        if k <= fi.front_size():
            return [fi.payload(key) for key in fi.diverse(k)]
        be = self._backend()
        recs = self.feasible()
        vecs = [be.canonical(r["objectives"]) for r in recs]
        return [recs[i] for i in select_diverse(vecs, k)]


def run_campaign(cells: Iterable,
                 store: CampaignStore | str, *, base_seed: int = 0,
                 population: int = 20, iterations: int = 30,
                 weights: Mapping[str, float] | None = None,
                 workers: int = 1,
                 progress: Callable[[str], None] | None = None,
                 backend: "str | Backend" = "fpga",
                 trace: bool = False,
                 verbose: bool = False,
                 searcher: str = "pso",
                 searcher_config: Mapping | None = None,
                 shard: int | str = 0,
                 screen_device=_CARD_WHERE_IT_APPLIES,
                 calibration=None,
                 policy: RetryPolicy | None = None,
                 retry_failed: bool = False,
                 install_signal_handlers: bool = True,
                 ) -> CampaignReport:
    """Run (or resume) a campaign against a JSONL store.

    ``backend`` selects the device family (``"fpga"`` — the default and
    the paper's flow — or ``"tpu"``; see :mod:`repro.dse.backends`) and
    must match the cells. Cells already in the store *with the same search
    config* (for FPGA: base seed, population, iterations, weights) are
    reused verbatim — zero new search evaluations — so re-running a
    finished campaign is free and a killed one picks up where it stopped;
    changing the search config re-runs the affected cells instead of
    serving stale designs. ``workers > 1`` fans the remaining cells over a
    spawn-based process pool; results land in the store in completion
    order, the report in cell order either way.

    ``trace=True`` records structured telemetry (:mod:`repro.obs`):
    per-cell queue-wait / eval / store-append spans and pool gauges land
    in per-process sidecars under ``<store>.events/``, which the parent
    merges into ``<store>.events.jsonl`` and exports as a Chrome trace
    (``<store>.trace.json``) when the campaign finishes; the report's
    ``events_path`` / ``trace_path`` point at both. Disabled (the
    default), no telemetry files are touched and the only residue is a
    no-op tracer. ``verbose`` adds per-cell convergence detail (stop
    reason, PSO cache hits) to the progress lines.

    ``store`` may name a v1 single JSONL file (the default layout) or a
    sharded ``<store>.d/`` directory (see :mod:`repro.dse.store`);
    ``shard`` names the shard THIS campaign process appends to, so
    several hosts can run disjoint slices of one grid against the same
    sharded store — each writes its own shard, resume reads them all —
    with no lock contention.

    ``searcher`` picks the FPGA cells' search engine
    (:data:`repro.core.search.SEARCHERS`; default ``"pso"``) and
    ``searcher_config`` overrides that engine's config fields. Both ride
    in the stored search config, so a store written by one engine never
    silently serves a campaign run under another — mismatched cells
    re-run. Backends that enumerate exhaustively (tpu, cuda) accept only
    the default engine.

    ``screen_device`` (fpga backend + ``searcher="hyperband"`` only)
    names the device that precomputes every to-run cell's rung-0
    screening fitnesses in ONE cross-cell call (:func:`prescreen_cells`)
    and hands each cell its slice — results are bit-identical to the
    per-cell NumPy screen. Left out, it is ``"cuda"`` for a hyperband
    campaign of the fpga backend and nothing otherwise; ``"cpu"`` runs
    the same screen on the CPU; ``None`` keeps the per-cell NumPy screen
    inside each cell's search. A device given with another backend or
    searcher raises ``ValueError``, and ``"cuda"`` without CUDA raises
    (:func:`repro_torch.device.resolve`): nothing falls back. The device
    stays out of the stored search config.

    ``calibration`` (a :class:`repro.calib.Calibration`) applies fitted
    per-part correction factors to every hardware spec the cells are
    evaluated against and stamps each record with the factors' provenance;
    its fingerprint joins the stored search config, so calibrated and
    uncalibrated results never mix on resume. ``None`` (the default) and
    the identity calibration are byte-identical to pre-calibration runs.

    Execution is fault-tolerant (:mod:`repro.dse.resilience`): ``policy``
    (default :class:`~repro.dse.resilience.RetryPolicy` seeded from
    ``base_seed``) retries transient per-cell failures with deterministic
    backoff, enforces an optional per-cell wall-clock timeout on the pool
    path, and survives worker crashes by rebuilding the pool and
    resubmitting the lost in-flight cells. A cell that exhausts its
    attempts is *quarantined* — stored as a ``status: "failed"`` record
    carrying the exception and per-attempt history — instead of aborting
    the campaign; quarantined cells resume as done until
    ``retry_failed=True`` (CLI ``--retry-failed``) opts them back in.
    SIGINT/SIGTERM (``install_signal_handlers``, main thread only) stop
    submissions, drain/cancel in-flight cells, flush the store and
    telemetry sidecars, and return a partial report
    (:attr:`CampaignReport.interrupted`; the CLI exits 3 with a resume
    hint). First-attempt successes are stored byte-identically to
    pre-resilience campaigns; only retried records gain a ``resilience``
    block.
    """
    from .backends import get_backend, run_cell_by_backend
    be = get_backend(backend)
    if searcher != "pso" and not getattr(be, "supports_searchers", False):
        raise ValueError(
            f"backend {be.name!r} enumerates its space exhaustively and "
            f"has no pluggable search engine; --searcher {searcher!r} is "
            f"only valid for the fpga backend")
    screened = be.name == "fpga" and searcher == "hyperband"
    if screen_device is _CARD_WHERE_IT_APPLIES:
        screen_device = "cuda" if screened else None
    elif screen_device is not None and not screened:
        raise ValueError(
            "screen_device precomputes hyperband rung-0 screening and "
            "applies only to the fpga backend with searcher='hyperband'")
    if screen_device is not None:
        from repro_torch.device import resolve
        screen_device = resolve(screen_device)
    cells = list(cells)
    store = open_store(store, shard=shard)

    tracer, events_dir = NULL, None
    if trace:
        events_dir = events_dir_for(store.path)
        if events_dir.exists():  # stale sidecars would pollute the merge
            for old in events_dir.glob("*.jsonl"):
                old.unlink()
        tracer = Tracer(events_dir / "main.jsonl", proc="main")
        if store.corrupt_lines:
            tracer.count("store.corrupt_lines", store.corrupt_lines,
                         store=str(store.path))

    t0 = time.perf_counter()
    search = be.search_config(base_seed=base_seed, population=population,
                              iterations=iterations, weights=weights,
                              searcher=searcher,
                              searcher_config=searcher_config,
                              calibration=calibration)
    # A stored cell counts as done only if it was searched with the same
    # settings; a config change re-runs (and overwrites) stale records.
    # Quarantined cells count as done too — a permanent failure must not
    # be re-hit on every resume — unless retry_failed opts them back in.
    policy = policy or RetryPolicy(seed=base_seed)
    todo, quarantined_prior = [], 0
    for c in cells:
        prior = store.get(c.key)
        if prior is None or prior.get("search") != search:
            todo.append(c)
        elif record_status(prior) != "ok":
            if retry_failed:
                todo.append(c)
            else:
                quarantined_prior += 1
    say = progress or (lambda _msg: None)
    say(f"campaign[{be.name}]: {len(cells)} cells, "
        f"{len(cells) - len(todo)} reused, "
        f"{len(todo)} to run (workers={workers})"
        + (f" — {quarantined_prior} quarantined cell(s) skipped; "
           f"--retry-failed re-runs them" if quarantined_prior else ""))
    tracer.count("cells.reused", len(cells) - len(todo))

    screen_fits: dict = {}
    if screen_device is not None and todo:
        # in the parent: pool workers get NumPy fits and never touch the
        # device
        with tracer.span("screen.device", cells=len(todo),
                         device=str(screen_device)):
            screen_fits = prescreen_cells(
                todo, base_seed=base_seed, population=population,
                iterations=iterations, searcher_config=searcher_config,
                calibration=calibration, device=screen_device)
        n = len(next(iter(screen_fits.values())))
        say(f"screened {len(screen_fits)} cells x {n} rung-0 candidates "
            f"in one call on {screen_device}")
        tracer.count("screen.device_cells", len(screen_fits))

    new_evals = 0
    done = 0
    failed_now = 0
    retried_now = 0
    pool_rebuilds = 0
    interrupted = False

    def finish(outcome) -> None:
        """Store and narrate one CellOutcome (success or quarantine)."""
        nonlocal new_evals, done, failed_now, retried_now
        rec = outcome.record
        if rec is None:           # interrupted mid-cell: nothing stored
            return
        done += 1
        with tracer.span("store.append", cell=outcome.cell.key):
            store.put(rec)
        elapsed = time.perf_counter() - t0
        if outcome.failed:
            failed_now += 1
            say(f"  [{done}/{len(todo)}] {outcome.cell.key}: FAILED — "
                f"{rec['error_type']} after {rec['attempts']} attempt(s), "
                f"quarantined | elapsed {elapsed:.1f}s")
            return
        if outcome.retried:
            retried_now += 1
        new_evals += rec["evaluations"]
        tracer.count("cells.done")
        eta = elapsed / done * (len(todo) - done)
        extra = ""
        if verbose and rec.get("trace"):
            tr = rec["trace"]
            extra = (f" [{tr.get('stop_reason', '?')}"
                     f"@{tr.get('iterations', '?')}it"
                     f", {tr.get('cache_hits', 0)} cache hits]")
        if outcome.retried:
            extra += f" [ok on attempt {len(outcome.attempt_log)}]"
        say(f"  [{done}/{len(todo)}] {outcome.cell.key}: {be.headline(rec)}, "
            f"{rec['evaluations']} evals, {rec['search_time_s']:.2f}s"
            f"{extra} | elapsed {elapsed:.1f}s, eta {eta:.0f}s")

    with interrupt_scope(install_signal_handlers) as stop, \
            tracer.span("campaign", backend=be.name, cells=len(cells),
                        todo=len(todo), workers=workers):
        if workers > 1 and len(todo) > 1:
            # spawn, not fork: callers routinely have torch (multithreaded,
            # maybe CUDA) initialized, and forking a threaded parent can
            # deadlock workers.
            ctx = multiprocessing.get_context("spawn")

            def make_pool():
                return ProcessPoolExecutor(max_workers=workers,
                                           mp_context=ctx)

            def submit(pool, c, attempt):
                obs = ({"events_dir": str(events_dir),
                        "t_submit": time.time()} if trace else None)
                return pool.submit(run_cell_by_backend, be.name, c,
                                   base_seed, population, iterations,
                                   weights, obs, searcher, searcher_config,
                                   screen_fits.get(c.key), calibration,
                                   attempt)

            stats = run_resilient_pool(
                todo, make_pool=make_pool, submit=submit,
                on_outcome=finish, policy=policy, search=search,
                backend=be.name, stop=stop, tracer=tracer,
                workers=workers)
            pool_rebuilds = stats.rebuilds
            interrupted = stats.interrupted
        else:
            def attempt_fn(cell, attempt):
                with tracer.span("cell.run", cell=cell.key,
                                 backend=be.name):
                    with tracer.span("cell.eval", cell=cell.key):
                        return run_cell_by_backend(
                            be.name, cell, base_seed, population,
                            iterations, weights, None, searcher,
                            searcher_config, screen_fits.get(cell.key),
                            calibration, attempt)

            for c in todo:
                if stop.is_set():
                    interrupted = True
                    break
                outcome = execute_cell(c, attempt_fn, policy,
                                       search=search, backend=be.name,
                                       stop=stop, tracer=tracer)
                interrupted = interrupted or outcome.interrupted
                finish(outcome)

    events_path = trace_json = None
    if trace:
        tracer.close()
        events_path = events_path_for(store.path)
        events = merge_events(events_dir, events_path)
        trace_json = chrome_path_for(store.path)
        trace_json.write_text(json.dumps(chrome_trace(events)))
        say(f"telemetry: {len(events)} events -> {events_path} "
            f"(chrome trace: {trace_json})")

    records = [rec for c in cells
               if (rec := store.get(c.key)) is not None]
    failed_total = sum(1 for r in records if not is_ok(r))
    missing = len(cells) - len(records)
    if interrupted:
        say(f"campaign interrupted — {done} of {len(todo)} scheduled "
            f"cell(s) stored and flushed; re-run the same command to "
            f"resume from here")
    return CampaignReport(cells, records, reused_cells=len(cells) - len(todo),
                          new_cells=done, new_evaluations=new_evals,
                          wall_time_s=time.perf_counter() - t0, backend=be,
                          events_path=events_path, trace_path=trace_json,
                          failed_cells=failed_total,
                          retried_cells=retried_now, missing_cells=missing,
                          pool_rebuilds=pool_rebuilds,
                          interrupted=interrupted)


if __name__ == "__main__":
    from .cli import run
    raise SystemExit(run())
