"""Cost-aware multi-family placement: which accelerator for which DNN.

Campaigns (:mod:`repro.dse.campaign`) answer "what is the best design of
ONE family for ONE workload"; the paper's end-to-end question — and the
benchmark-then-place loop Being-ahead (arXiv:2104.02251) frames across
heterogeneous accelerators — is one level up: *given a mix of workloads
and a budget, which hardware should each one run on?* This module answers
it from campaign evidence that already exists:

* **Workloads** are named entries of the campaign key space: an
  ``arch/shape`` pair from :mod:`repro.configs` (hostable by BOTH the
  ``tpu`` and ``cuda`` backends — they share that key space on purpose)
  or a ``net@size`` pair from the paper's FPGA domain.
* **Candidates** come from one or more campaign stores (mixed backends
  welcome; later stores win on duplicate cell keys, mirroring store
  concatenation). Every feasible record is re-expressed in ONE
  normalized objective (:data:`repro.dse.objectives.NORMALIZED_OBJECTIVES`)
  and costed in watts and hourly dollars via each backend's
  ``record_cost`` hook over the ``hw_specs`` TDP/$ tables.
* **The budget** is a :class:`repro.core.hw_specs.CostEnvelope` — a
  dollar-proxy cap, a watt cap, or both.
* **Solvers** pick one candidate per workload maximizing the summed
  objective under the budget (a multiple-choice knapsack): ``greedy``
  starts every workload at its cheapest feasible design and repeatedly
  applies the upgrade with the best marginal value per unit of budget
  pressure; ``exact`` enumerates the (dominance-pruned) assignment space
  with bound pruning and is exact for the small mixes it accepts;
  ``auto`` picks ``exact`` when the pruned space is small enough.
* When no store covers a workload, the per-backend ``coverage_cells``
  hook says what to evaluate, and ``--evaluate-missing`` runs those
  cells as a fresh campaign before placing.

The result renders as a Markdown report section
(:func:`repro.dse.report.render_placement`): the assignment table,
budget utilization, and marginal "next dollar / next watt" suggestions —
the cheapest budget raise that would change the answer.

Placement in 5 lines (the README carries this block verbatim)::

    # Which family/part/count for each workload, under $40/h and 10 kW:
    python -m repro.dse.placement --stores results/dse_tpu.jsonl results/dse_cuda.jsonl \\
        --workloads starcoder2-3b/train_4k,xlstm-350m/decode_32k \\
        --budget-usd 40 --budget-watts 10000 --solver auto \\
        --out docs/reports/placement.md
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Iterable, Mapping, Sequence

from repro_torch.core.hw_specs import CostEnvelope

from .backends import BACKENDS, get_backend, record_backend, workload_families
from .objectives import NORMALIZED_OBJECTIVES
from .frontier import FrontierIndex
from .store import CampaignStore, is_ok, open_store

#: Normalized objective names a placement can maximize.
PLACEMENT_OBJECTIVES: tuple[str, ...] = tuple(
    s.name for s in NORMALIZED_OBJECTIVES)

#: ``auto`` uses the exact solver when the dominance-pruned assignment
#: space has at most this many points; beyond it, greedy.
EXACT_AUTO_LIMIT = 100_000

#: Hard node cap for the exact solver's search (safety valve; pruning
#: keeps realistic mixes far below it).
EXACT_NODE_LIMIT = 2_000_000


class PlacementError(Exception):
    """Base class; the CLI maps these to exit code 2 with a clean
    one-line diagnostic instead of a traceback."""


class CoverageError(PlacementError):
    def __init__(self, workloads: Sequence[str]):
        self.workloads = list(workloads)
        super().__init__(
            "no store coverage for workload(s): " + ", ".join(self.workloads)
            + " — run a campaign for them first, or pass --evaluate-missing "
              "to let placement fill the gap with fresh evaluations")


class BudgetInfeasibleError(PlacementError):
    def __init__(self, budget: CostEnvelope, cheapest: "list[Assignment]"):
        self.budget, self.cheapest = budget, cheapest
        usd = sum(a.candidate.usd_per_hour for a in cheapest)
        watts = sum(a.candidate.watts for a in cheapest)
        floor = ", ".join(
            f"{a.workload}: ${a.candidate.usd_per_hour:g}/h"
            f"+{a.candidate.watts:g}W" for a in cheapest)
        super().__init__(
            f"budget {budget.describe()} is infeasible: the cheapest "
            f"assignment already needs ${usd:g}/h and {watts:g} W "
            f"({floor})")


@dataclasses.dataclass
class Candidate:
    """One store record as a placement option: its workload key, its
    value under the chosen normalized objective, and its hardware cost."""

    workload: str
    backend: str
    cell_key: str
    value: float
    watts: float
    usd_per_hour: float
    part: str
    count: int
    point: str
    record: Mapping


@dataclasses.dataclass
class Assignment:
    workload: str
    candidate: Candidate


@dataclasses.dataclass
class Suggestion:
    """A beneficial upgrade the budget rejects: the marginal "next
    dollar / next watt" evidence in the report."""

    workload: str
    candidate: Candidate
    gain: float
    d_usd: float
    d_watts: float
    blocked_by: tuple[str, ...]   # ("usd_per_hour",), ("watts",), or both


@dataclasses.dataclass
class PlacementResult:
    objective: str
    solver: str                        # solver actually used
    budget: CostEnvelope
    assignments: list[Assignment]      # input workload order
    suggestions: list[Suggestion]
    options: dict[str, tuple[int, int]]  # workload -> (raw, pruned) counts
    explored: int                      # upgrade steps / search nodes

    @property
    def total_value(self) -> float:
        return sum(a.candidate.value for a in self.assignments)

    @property
    def total_usd(self) -> float:
        return sum(a.candidate.usd_per_hour for a in self.assignments)

    @property
    def total_watts(self) -> float:
        return sum(a.candidate.watts for a in self.assignments)

    def utilization(self) -> dict[str, tuple[float, float | None]]:
        """Per budget axis: (used, cap). Uncapped axes report cap None."""
        return {"usd_per_hour": (self.total_usd, self.budget.usd_per_hour),
                "watts": (self.total_watts, self.budget.watts)}


# ---------------------------------------------------------------------------
# workloads and candidates
# ---------------------------------------------------------------------------


def normalize_workload(token: str) -> str:
    """A CLI workload token -> its canonical store key. ``arch/shape``
    passes through; FPGA tokens normalize to the backend's group-key form
    (``vgg16@224`` -> ``vgg16@224x224``, bare fixed nets -> ``@native``).
    Unknown names raise ``KeyError`` listing the accepted forms."""
    token = token.strip()
    if workload_families(token) == ("tpu", "cuda"):
        return token
    net, sep, size = token.partition("@")
    if not sep or size in ("", "native"):
        key = f"{net}@native"
    else:
        from .campaign import RESIZABLE_NETS
        if net not in RESIZABLE_NETS and workload_families(f"{net}@native"):
            # fixed-topology nets always record as @native; a sized key
            # could never match any store record
            raise KeyError(f"bad workload {token!r}: {net} has a fixed "
                           f"input topology; use {net!r} or "
                           f"'{net}@native'")
        h, _, w = size.partition("x")
        try:
            key = f"{net}@{int(h)}x{int(w or h)}"
        except ValueError:
            raise KeyError(f"bad workload {token!r}: input size {size!r} "
                           f"is not H or HxW") from None
    if not workload_families(key):
        raise KeyError(
            f"unknown workload {token!r}; expected arch/shape (e.g. "
            f"starcoder2-3b/train_4k) or net[@HxW] (e.g. vgg16@224x224)")
    return key


def parse_workloads(text: str) -> list[str]:
    """Comma list of workload tokens -> canonical keys, deduped in order."""
    out: list[str] = []
    for tok in text.split(","):
        if not tok.strip():
            continue
        key = normalize_workload(tok)
        if key not in out:
            out.append(key)
    if not out:
        raise KeyError("empty workload list")
    return out


def pooled_records(stores: Sequence[CampaignStore | Iterable[Mapping]],
                   ) -> list[dict]:
    """Records of several stores merged by cell key, LATER STORES WINNING
    — the same last-wins rule a concatenated JSONL store follows, so a
    resumed or re-run store never double-counts a cell. Stores are
    streamed (``iter_records``), never materialized. Quarantined
    (``status: failed``) records participate in last-wins — a later
    success supersedes a failure and vice versa — and are filtered out
    downstream by ``candidates_by_workload``."""
    merged: dict[str, dict] = {}
    for s in stores:
        recs = s.iter_records() if isinstance(s, CampaignStore) else s
        for rec in recs:
            key = rec.get("cell_key")
            if key:
                merged[key] = rec
    return list(merged.values())


def candidates_by_workload(records: Sequence[Mapping], objective: str,
                           ) -> dict[str, list[Candidate]]:
    """Feasible records of known backends -> placement candidates grouped
    by workload key, each valued under one normalized objective and
    costed via the backend's ``record_cost`` hook."""
    if objective not in PLACEMENT_OBJECTIVES:
        raise KeyError(f"unknown objective {objective!r}; "
                       f"choose from {PLACEMENT_OBJECTIVES}")
    out: dict[str, list[Candidate]] = {}
    for rec in records:
        if not is_ok(rec):
            continue  # quarantined (status: failed) — never placeable
        name = record_backend(rec)
        if name not in BACKENDS:
            continue
        be = get_backend(name)
        try:
            norm = be.normalized(rec)
        except (KeyError, TypeError):
            continue  # foreign/truncated record: not placeable
        if not norm["feasible"]:
            continue
        watts, usd = be.record_cost(rec)
        pp = be.placement_point(rec)
        c = Candidate(workload=be.group_key(rec), backend=name,
                      cell_key=rec["cell_key"], value=float(norm[objective]),
                      watts=watts, usd_per_hour=usd, part=pp["part"],
                      count=pp["count"], point=pp["point"], record=rec)
        out.setdefault(c.workload, []).append(c)
    for cands in out.values():
        cands.sort(key=lambda c: (c.cell_key, c.backend))
    return out


def _dominated(c: Candidate, by: Candidate, axes: Sequence[str]) -> bool:
    """``by`` is at least as good on value and every budgeted cost axis,
    and strictly better somewhere (exact ties defer to the smaller cell
    key, so duplicates collapse deterministically)."""
    if by.value < c.value:
        return False
    if any(getattr(by, a) > getattr(c, a) for a in axes):
        return False
    if by.value > c.value or any(getattr(by, a) < getattr(c, a)
                                 for a in axes):
        return True
    return by.cell_key < c.cell_key  # exact tie: one survivor


def prune_candidates(cands: Sequence[Candidate], budget: CostEnvelope,
                     ) -> list[Candidate]:
    """Drop candidates another one beats on value without costing more on
    any budgeted axis. With no caps this keeps just the best-value
    design; with caps it keeps the value-vs-cost frontier.

    Runs through the incremental dominance archive
    (:class:`repro.dse.frontier.FrontierIndex`) — O(n · front) instead of
    the old all-pairs O(n²) — with :func:`_dominated`'s exact-tie rule
    (identical vectors collapse to the smallest cell key) applied on top,
    since the archive itself keeps duplicates."""
    axes = budget.capped_axes()
    if not cands:
        return []
    # canonical maximization form: value up, every budgeted cost down
    vecs = [(c.value,) + tuple(-getattr(c, a) for a in axes) for c in cands]
    tie_winner: dict[tuple, str] = {}
    for c, v in zip(cands, vecs):
        if v not in tie_winner or c.cell_key < tie_winner[v]:
            tie_winner[v] = c.cell_key
    fi = FrontierIndex()
    for i, v in enumerate(vecs):
        fi.insert(i, v)
    on_front = set(fi.front_keys())
    return [c for i, c in enumerate(cands)
            if i in on_front and c.cell_key == tie_winner[vecs[i]]]


# ---------------------------------------------------------------------------
# solvers (multiple-choice knapsack)
# ---------------------------------------------------------------------------


def _pressure(budget: CostEnvelope, d_usd: float, d_watts: float) -> float:
    """How much of the budget an upgrade's marginal cost eats: the max
    over capped axes of (cost increase / cap). The greedy ratio divides
    value gained by this, so a watt-capped and a dollar-capped run rank
    upgrades in their own currency."""
    terms = []
    if budget.usd_per_hour:
        terms.append(max(0.0, d_usd) / budget.usd_per_hour)
    if budget.watts:
        terms.append(max(0.0, d_watts) / budget.watts)
    return max(terms) if terms else 0.0


def _cheapest(cands: Sequence[Candidate], budget: CostEnvelope) -> Candidate:
    """The candidate that strains the budget least: minimal pressure
    (the max of cost/cap over capped axes — NOT lexicographic, so a
    $1/h-but-100W design doesn't beat a $2/h-but-10W one under a tight
    watt cap), then raw costs, value, and key for determinism."""
    def key(c: Candidate):
        return (_pressure(budget, c.usd_per_hour, c.watts),
                c.usd_per_hour, c.watts, -c.value, c.cell_key)
    return min(cands, key=key)


def _upgrade_better(a: tuple, b: tuple) -> bool:
    """Greedy upgrade preference: higher ratio, then higher gain, then
    the lexicographically first (workload, cell key) for determinism."""
    (ra, ga, wa, ca), (rb, gb, wb, cb) = a, b
    if ra != rb:
        return ra > rb
    if ga != gb:
        return ga > gb
    return (wa, ca.cell_key) < (wb, cb.cell_key)


def _solve_greedy(workloads: Sequence[str],
                  cands: Mapping[str, Sequence[Candidate]],
                  budget: CostEnvelope) -> tuple[dict[str, Candidate], int]:
    """Start every workload at its least-straining candidate, then apply
    best-ratio upgrades while they fit. A heuristic: near-optimal in
    practice, but its infeasibility verdict is conservative when the two
    caps pull different ways across workloads — the exact solver is
    authoritative there."""
    assign = {w: _cheapest(cands[w], budget) for w in workloads}
    usd = sum(c.usd_per_hour for c in assign.values())
    watts = sum(c.watts for c in assign.values())
    if not budget.admits(usd, watts):
        raise BudgetInfeasibleError(
            budget, [Assignment(w, assign[w]) for w in workloads])
    steps = 0
    while True:
        best = None
        for w in workloads:
            cur = assign[w]
            for c in cands[w]:
                gain = c.value - cur.value
                if gain <= 0:
                    continue
                du, dw = c.usd_per_hour - cur.usd_per_hour, c.watts - cur.watts
                if not budget.admits(usd + du, watts + dw):
                    continue
                steps += 1
                p = _pressure(budget, du, dw)
                cand = (gain / p if p > 0 else math.inf, gain, w, c)
                if best is None or _upgrade_better(cand, best):
                    best = cand
        if best is None:
            return assign, steps
        _, _, w, c = best
        usd += c.usd_per_hour - assign[w].usd_per_hour
        watts += c.watts - assign[w].watts
        assign[w] = c


def _solve_exact(workloads: Sequence[str],
                 cands: Mapping[str, Sequence[Candidate]],
                 budget: CostEnvelope) -> tuple[dict[str, Candidate], int]:
    """Depth-first enumeration with value/cost bound pruning. Exact (and
    deterministic: value, then lower cost, then lexicographic cell keys)
    for the small mixes ``auto`` routes here."""
    # cheapest-first within a workload tightens the cost bound early;
    # fewest-options-first shrinks the branching factor at the top.
    order = sorted(workloads, key=lambda w: (len(cands[w]), w))
    opts = [sorted(cands[w], key=lambda c: (c.usd_per_hour, c.watts,
                                            -c.value, c.cell_key))
            for w in order]
    n = len(order)
    min_usd = [0.0] * (n + 1)
    min_watts = [0.0] * (n + 1)
    max_val = [0.0] * (n + 1)
    for i in range(n - 1, -1, -1):
        min_usd[i] = min_usd[i + 1] + min(c.usd_per_hour for c in opts[i])
        min_watts[i] = min_watts[i + 1] + min(c.watts for c in opts[i])
        max_val[i] = max_val[i + 1] + max(c.value for c in opts[i])

    best: dict = {"key": None, "tie": None, "picks": None}
    picks: list[Candidate] = []
    nodes = 0

    def dfs(i: int, usd: float, watts: float, value: float) -> None:
        nonlocal nodes
        nodes += 1
        if nodes > EXACT_NODE_LIMIT:
            raise PlacementError(
                f"exact solver exceeded {EXACT_NODE_LIMIT} nodes; "
                f"re-run with --solver greedy")
        if not budget.admits(usd + min_usd[i], watts + min_watts[i]):
            return
        if best["key"] is not None and value + max_val[i] < best["key"][0]:
            return
        if i == n:
            key = (value, -usd, -watts)
            tie = tuple(c.cell_key for c in picks)
            if best["key"] is None or key > best["key"] or \
                    (key == best["key"] and tie < best["tie"]):
                best.update(key=key, tie=tie, picks=list(picks))
            return
        for c in opts[i]:
            picks.append(c)
            dfs(i + 1, usd + c.usd_per_hour, watts + c.watts, value + c.value)
            picks.pop()

    dfs(0, 0.0, 0.0, 0.0)
    if best["picks"] is None:
        raise BudgetInfeasibleError(
            budget, [Assignment(w, _cheapest(cands[w], budget))
                     for w in workloads])
    return dict(zip(order, best["picks"])), nodes


def marginal_upgrades(assign: Mapping[str, Candidate],
                      cands: Mapping[str, Sequence[Candidate]],
                      budget: CostEnvelope) -> list[Suggestion]:
    """Per workload, the best value-raising upgrade the budget REJECTS —
    what the next dollar (or watt) of budget would buy. In-budget
    upgrades are excluded: the solvers already took them."""
    usd = sum(c.usd_per_hour for c in assign.values())
    watts = sum(c.watts for c in assign.values())
    out = []
    for w in sorted(assign):
        cur, best = assign[w], None
        for c in cands[w]:
            gain = c.value - cur.value
            if gain <= 0:
                continue
            du, dw = c.usd_per_hour - cur.usd_per_hour, c.watts - cur.watts
            if budget.admits(usd + du, watts + dw):
                continue
            p = _pressure(budget, du, dw)
            cand = (gain / p if p > 0 else math.inf, gain, w, c)
            if best is None or _upgrade_better(cand, best):
                best = cand
        if best is not None:
            _, gain, _, c = best
            du = c.usd_per_hour - cur.usd_per_hour
            dw = c.watts - cur.watts
            blocked = tuple(
                a for a, used, delta, cap in (
                    ("usd_per_hour", usd, du, budget.usd_per_hour),
                    ("watts", watts, dw, budget.watts))
                if cap is not None and used + delta > cap)
            out.append(Suggestion(w, c, gain, du, dw, blocked))
    out.sort(key=lambda s: (-(s.gain / p if (p := _pressure(
        budget, s.d_usd, s.d_watts)) > 0 else math.inf), s.workload))
    return out


# ---------------------------------------------------------------------------
# the placement entry point
# ---------------------------------------------------------------------------


def place(workloads: Sequence[str], records: Sequence[Mapping],
          budget: CostEnvelope, *, objective: str = "tflops",
          solver: str = "auto",
          candidates: Mapping[str, Sequence[Candidate]] | None = None,
          ) -> PlacementResult:
    """Assign each workload the best-covering design under the budget.

    ``records`` is any pooled record list (see :func:`pooled_records`);
    ``workloads`` are canonical keys (see :func:`parse_workloads`).
    ``candidates`` short-circuits extraction when the caller already ran
    :func:`candidates_by_workload` on the same records and objective.
    Raises :class:`CoverageError` when a workload has no feasible
    candidate and :class:`BudgetInfeasibleError` when even the cheapest
    assignment busts the budget.
    """
    if solver not in ("auto", "greedy", "exact"):
        raise KeyError(f"unknown solver {solver!r}; "
                       f"choose from auto, greedy, exact")
    workloads = list(workloads)
    all_cands = (candidates if candidates is not None
                 else candidates_by_workload(records, objective))
    missing = [w for w in workloads if not all_cands.get(w)]
    if missing:
        raise CoverageError(missing)
    raw = {w: all_cands[w] for w in workloads}
    pruned = {w: prune_candidates(raw[w], budget) for w in workloads}
    options = {w: (len(raw[w]), len(pruned[w])) for w in workloads}

    if solver == "auto":
        space = math.prod(len(pruned[w]) for w in workloads)
        solver = "exact" if space <= EXACT_AUTO_LIMIT else "greedy"
    if solver == "exact":
        assign, explored = _solve_exact(workloads, pruned, budget)
    else:
        assign, explored = _solve_greedy(workloads, pruned, budget)

    return PlacementResult(
        objective=objective, solver=solver, budget=budget,
        assignments=[Assignment(w, assign[w]) for w in workloads],
        suggestions=marginal_upgrades(assign, pruned, budget),
        options=options, explored=explored)


def ensure_coverage(workloads: Sequence[str], store: CampaignStore,
                    known: Mapping[str, Sequence[Candidate]], *,
                    progress=None, workers: int = 1) -> list[str]:
    """Run the per-backend default campaign (``coverage_cells``) for every
    workload ``known`` has no candidates for, into ``store``. Returns the
    workloads it evaluated. The fresh records land in the store like any
    campaign's would, so the next placement resumes them for free."""
    from .campaign import run_campaign
    evaluated = []
    for w in workloads:
        if known.get(w):
            continue
        for family in workload_families(w):
            cells = get_backend(family).coverage_cells(w)
            if cells:
                run_campaign(cells, store, backend=family, workers=workers,
                             progress=progress)
        evaluated.append(w)
    return evaluated


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _summary_lines(result: PlacementResult) -> list[str]:
    unit = {s.name: s.units for s in NORMALIZED_OBJECTIVES}[result.objective]
    lines = [f"placement[{result.solver}]: {len(result.assignments)} "
             f"workload(s), objective {result.objective} ({unit}), "
             f"budget {result.budget.describe()}"]
    for a in result.assignments:
        c = a.candidate
        lines.append(f"  {a.workload:<32} -> {c.backend}:{c.part} x{c.count} "
                     f"[{c.point}] {c.value:.4g} {unit}  "
                     f"(${c.usd_per_hour:g}/h, {c.watts:g} W)")
    lines.append(f"  total: {result.total_value:.4g} {unit}, "
                 f"${result.total_usd:g}/h, {result.total_watts:g} W")
    for s in result.suggestions[:3]:
        lines.append(f"  next: {s.workload} -> {s.candidate.cell_key} "
                     f"(+{s.gain:.4g} {unit} for {s.d_usd:+g} $/h, "
                     f"{s.d_watts:+g} W; blocked by "
                     f"{', '.join(s.blocked_by) or 'budget'})")
    return lines


def selftest() -> int:
    """Deterministic end-to-end check on the built-in fixture store: both
    solvers agree, re-running is byte-identical, and the rendered report
    has every section. The CI docs job runs this."""
    from .report import fixture_records, render_placement
    recs = fixture_records()
    workloads = parse_workloads(
        "starcoder2-3b/train_4k,xlstm-350m/decode_32k,vgg16@224x224")
    budget = CostEnvelope(usd_per_hour=60.0, watts=25000.0)
    exact = place(workloads, recs, budget, solver="exact")
    greedy = place(workloads, recs, budget, solver="greedy")
    again = place(workloads, recs, budget, solver="exact")
    pick = lambda r: [(a.workload, a.candidate.cell_key)
                      for a in r.assignments]
    if pick(exact) != pick(again):
        raise SystemExit("selftest: exact placement is not deterministic")
    if pick(exact) != pick(greedy):
        raise SystemExit(f"selftest: greedy diverged from exact on the "
                         f"fixture: {pick(greedy)} vs {pick(exact)}")
    if not exact.suggestions:
        raise SystemExit("selftest: fixture budget should leave a rejected "
                         "upgrade for the marginal table")
    md = render_placement(exact, title="selftest placement")
    for must in ("## Assignment", "## Budget utilization",
                 "## Marginal upgrades", "workload", "family"):
        if must not in md:
            raise SystemExit(f"selftest: section {must!r} missing from "
                             f"rendered placement report")
    try:
        place(workloads, recs, CostEnvelope(usd_per_hour=1.0))
    except BudgetInfeasibleError:
        pass
    else:
        raise SystemExit("selftest: $1/h budget should be infeasible")
    try:
        place(["whisper-base/train_4k"], recs, budget)
    except CoverageError:
        pass
    else:
        raise SystemExit("selftest: uncovered workload should raise")
    print(f"selftest OK: {len(md)} chars, exact==greedy on "
          f"{len(workloads)} workloads, infeasible/uncovered diagnostics "
          f"raised")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse.placement",
        description="Cost-aware multi-family placement: assign each "
                    "workload of a mix the best campaign design (any "
                    "family) under a dollar/watt budget.")
    ap.add_argument("--stores", nargs="+", default=[], metavar="STORE",
                    help="campaign JSONL stores to draw candidates from "
                         "(mixed backends welcome; later stores win on "
                         "duplicate cells)")
    ap.add_argument("--workloads", default="",
                    help="comma list of workload keys: arch/shape (tpu+"
                         "cuda) or net[@HxW] (fpga); 'all' = every "
                         "workload the stores cover")
    ap.add_argument("--budget-usd", type=float, default=None, metavar="USD",
                    help="hourly dollar-proxy cap (hw_specs usd_per_hour "
                         "tables)")
    ap.add_argument("--budget-watts", type=float, default=None, metavar="W",
                    help="board-power cap (hw_specs tdp_watts tables)")
    ap.add_argument("--objective", default="tflops",
                    choices=PLACEMENT_OBJECTIVES,
                    help="normalized objective to maximize "
                         "(default: %(default)s)")
    ap.add_argument("--solver", default="auto",
                    choices=("auto", "greedy", "exact"),
                    help="auto = exact for small mixes, else greedy")
    ap.add_argument("--evaluate-missing", action="store_true",
                    help="run the default campaign for workloads the "
                         "stores don't cover (into --eval-store)")
    ap.add_argument("--eval-store", default=None, metavar="STORE",
                    help="where fresh coverage evaluations land "
                         "(default: the first --stores entry)")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool width for coverage evaluations")
    ap.add_argument("--out", default=None, metavar="MD",
                    help="write the Markdown placement report here")
    ap.add_argument("--title", default=None)
    ap.add_argument("--fixture", action="store_true",
                    help="use the built-in three-backend fixture store "
                         "instead of --stores (deterministic; the docs "
                         "worked example)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the deterministic fixture checks and exit")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest()

    from .report import fixture_records, render_placement
    if args.fixture:
        records = fixture_records()
    elif args.stores:
        records = pooled_records([open_store(p) for p in args.stores])
        if not records:
            ap.error(f"stores {args.stores} are empty or missing")
    else:
        ap.error("pass --stores (or --fixture / --selftest)")

    budget = CostEnvelope(usd_per_hour=args.budget_usd,
                          watts=args.budget_watts)
    # one candidate extraction serves the "all" listing, the coverage
    # check, and the solve — unless fresh evaluations change the records
    known = candidates_by_workload(records, args.objective)
    try:
        if args.workloads.strip().lower() in ("", "all"):
            workloads = sorted(known)
            if not workloads:
                ap.error("no placeable workloads in the stores")
        else:
            workloads = parse_workloads(args.workloads)
    except KeyError as e:
        ap.error(str(e.args[0] if e.args else e))

    if args.evaluate_missing and not args.fixture:
        eval_store = open_store(args.eval_store or args.stores[0])
        filled = ensure_coverage(workloads, eval_store, known,
                                 progress=print, workers=args.workers)
        if filled:
            records = pooled_records([records, eval_store.iter_records()])
            known = candidates_by_workload(records, args.objective)

    try:
        result = place(workloads, records, budget,
                       objective=args.objective, solver=args.solver,
                       candidates=known)
    except PlacementError as e:
        print(f"placement failed: {e}", file=sys.stderr)
        return 2

    print("\n".join(_summary_lines(result)))
    if args.out:
        from pathlib import Path
        md = render_placement(result, title=args.title)
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(md)
        print(f"placement report -> {out} ({len(md)} chars)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
