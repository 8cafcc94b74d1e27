"""Markdown campaign reports from JSONL stores (+ optional bench JSON).

The ROADMAP's "perf-trajectory dashboard": turn any
:class:`repro.dse.store.CampaignStore` — FPGA, TPU, or a mixed store —
into a human-readable Markdown report under ``docs/reports/``.

Rendering is *streaming*: every section is built by per-backend /
cross-backend accumulators (record counts, running per-workload winners,
and an incremental Pareto archive —
:class:`repro.dse.frontier.FrontierIndex`) fed one record at a time, so
a 100k-record store renders in ONE pass over ``iter_records()`` with
O(frontier) memory instead of materializing and re-sorting the full
record list. Sections:

* per-backend **Pareto frontier tables**, ordered by NSGA-II rank +
  crowding distance so a truncated read-off still spreads across the
  trade-off surface (extremes first, clumps thinned);
* **per-workload winners** (best scalarized design per net@input / per
  arch/shape), following HybridDNN's practice of reporting the
  efficiency/latency trade-off per workload rather than a single scalar;
* **objective trade-off summaries** — for each objective, the frontier
  design that is best at it and what that choice costs on the others;
* a **cross-backend frontier** whenever a store mixes device families:
  every record re-expressed in the normalized objective schema
  (delivered TFLOP/s, per watt, per dollar-proxy, per peak TFLOP) and
  Pareto-sorted into ONE frontier, plus per-backend champions;
* an optional **benchmark appendix** from ``benchmarks/run.py --json``
  output, so paper-figure reproductions land in the same document.

A second mode, ``--compare``, takes TWO OR MORE stores (e.g. the same
campaign re-run over time, or sibling backends' campaigns) and renders the
*trajectory* between them: per-workload winner deltas, best-normalized-
objective trajectories across the store sequence, and a pooled
cross-backend frontier annotated with which store each design came from.

CLI (also ``python -m repro.dse.report``)::

    python -m repro.dse.report results/dse.jsonl --out docs/reports/fpga.md
    python -m repro.dse.report results/dse_tpu.jsonl --bench bench.json
    python -m repro.dse.report --compare results/dse_tpu.jsonl \\
        results/dse_cuda.jsonl --out docs/reports/tpu_vs_cuda.md
    python -m repro.dse.report --selftest   # render the built-in fixture

``--selftest`` renders a small built-in fixture store (all three
backends) through the full pipeline — including the cross-backend and
compare paths — and fails loudly if anything regresses; CI runs it as
the docs check.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Iterable, Mapping, Sequence

from repro_torch.obs import (campaign_wall, counter_totals, events_path_for,
                       load_events, slowest_spans, span_totals,
                       worker_utilization)

from .backends import BACKENDS, get_backend, record_backend
from .frontier import FrontierIndex
from .objectives import (NORMALIZED_DEFAULT_WEIGHTS, NORMALIZED_OBJECTIVES,
                         canonical_vector, scalarize_values)
from .store import open_store, record_status

#: Where reports land unless --out says otherwise.
DEFAULT_REPORT_DIR = Path("docs/reports")


# ---------------------------------------------------------------------------
# markdown helpers
# ---------------------------------------------------------------------------


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _table(headers: Sequence[str], rows: Sequence[Sequence]) -> list[str]:
    # cell keys contain "|" (the axis separator) — escape so Markdown
    # doesn't read them as column breaks
    esc = lambda v: _fmt(v).replace("|", "\\|")
    out = ["| " + " | ".join(esc(h) for h in headers) + " |",
           "|" + "|".join(" --- " for _ in headers) + "|"]
    for row in rows:
        out.append("| " + " | ".join(esc(v) for v in row) + " |")
    return out


def _objective_columns(be) -> list[str]:
    return [f"{s.name} ({'max' if s.maximize else 'min'}, {s.units})"
            for s in be.objectives]


def _objective_values(be, rec: Mapping) -> list:
    return [rec["objectives"][s.name] for s in be.objectives]


# ---------------------------------------------------------------------------
# report body
# ---------------------------------------------------------------------------


class _BackendAcc:
    """Streaming per-backend report state: record/feasible counts, the
    incremental Pareto archive (integer keys in feasible-arrival order,
    records as payloads), and running per-workload winners — one
    :meth:`add` per record, no record list retained."""

    def __init__(self, name: str):
        self.name = name
        self.known = name in BACKENDS
        self.be = get_backend(name) if self.known else None
        self.count = 0
        self.feasible = 0
        self.failed = 0
        self.fi = FrontierIndex()
        self.winners: dict[str, tuple[float, dict]] = {}

    def add(self, rec: Mapping) -> None:
        self.count += 1
        if record_status(rec) != "ok":
            # quarantined cell: counted, never ranked/frontiered
            self.failed += 1
            return
        if not self.known or not rec.get("objectives", {}).get("feasible"):
            return
        be = self.be
        self.fi.insert(self.feasible, be.canonical(rec["objectives"]),
                       payload=rec)
        self.feasible += 1
        g = be.group_key(rec)
        score = be.scalarize(rec["objectives"])
        best = self.winners.get(g)
        # strict > keeps the FIRST maximum, matching max() over a list
        if best is None or score > best[0]:
            self.winners[g] = (score, rec)

    def section(self, k: int) -> list[str]:
        be = self.be
        lines = [f"## Backend `{self.name}` — {self.count} cells, "
                 f"{self.feasible} feasible"
                 + (f", {self.failed} quarantined" if self.failed else ""),
                 ""]
        lines += ["Objectives: " + ", ".join(
            f"`{s.name}` ({'max' if s.maximize else 'min'}, {s.units})"
            for s in be.objectives), ""]
        if not self.feasible:
            lines += ["_No feasible designs in this store._", ""]
            return lines

        # diversity order: whole front sorted by crowding so the top rows
        # are the spread, not a clump around one region
        entries = {key: (vec, rec) for key, vec, rec in self.fi.front()}
        order = self.fi.diverse()
        front = [entries[key][1] for key in order]
        fvecs = [entries[key][0] for key in order]

        lines += [f"### Pareto frontier ({len(front)} of {self.feasible} "
                  f"feasible, crowding-distance order)", ""]
        cols = ["cell"] + _objective_columns(be)
        rows = [[f"`{r['cell_key']}`"] + _objective_values(be, r)
                for r in front[:len(front) if k <= 0 else k]]
        shown = len(rows)
        lines += _table(cols, rows)
        if shown < len(front):
            lines += ["", f"_{len(front) - shown} more frontier designs in "
                          f"the store (rerun with `--top {len(front)}`)._"]
        lines += [""]

        lines += [f"### Per-workload winners "
                  f"(best by default weights {dict(be.default_weights)})", ""]
        rows = []
        for g in sorted(self.winners):
            win = self.winners[g][1]
            rows.append([g, f"`{win['cell_key']}`"]
                        + _objective_values(be, win))
        lines += _table(["workload", "cell"] + _objective_columns(be), rows)
        lines += [""]

        # trade-off summary: the frontier specialist per objective
        lines += ["### Objective trade-offs (frontier specialist per "
                  "objective)", ""]
        rows = []
        for j, spec in enumerate(be.objectives):
            best_i = max(range(len(front)), key=lambda i: fvecs[i][j])
            rows.append([f"`{spec.name}`", f"`{front[best_i]['cell_key']}`"]
                        + _objective_values(be, front[best_i]))
        lines += _table(["best at", "cell"] + _objective_columns(be), rows)
        lines += [""]
        return lines


def _norm_row(r: Mapping, label: str | None = None) -> dict | None:
    """One record -> its cross-backend normalized row
    (``{rec, backend, norm, label}``), or ``None`` when the record is
    from an unknown backend, not normalizable, or infeasible."""
    if record_status(r) != "ok":
        return None  # quarantined (status: failed) — never ranked/pooled
    name = record_backend(r)
    if name not in BACKENDS:
        return None
    be = get_backend(name)
    try:
        norm = be.normalized(r)
    except (KeyError, TypeError):
        return None  # foreign/truncated record: not normalizable
    if not norm["feasible"]:
        return None
    return {"rec": r, "backend": name, "norm": norm, "label": label}


def _normalized_rows(records: Sequence[Mapping],
                     label: str | None = None) -> list[dict]:
    """Feasible records of known backends, re-expressed in the
    cross-backend normalized schema: ``{rec, backend, norm, label}``."""
    return [row for r in records
            if (row := _norm_row(r, label)) is not None]


def _norm_score(row: Mapping) -> float:
    return scalarize_values(row["norm"], NORMALIZED_OBJECTIVES, None,
                            NORMALIZED_DEFAULT_WEIGHTS)


def _normalized_columns() -> list[str]:
    return [f"{s.name} (max, {s.units})" for s in NORMALIZED_OBJECTIVES]


def _normalized_values(norm: Mapping) -> list:
    return [norm[s.name] for s in NORMALIZED_OBJECTIVES]


class _NormAcc:
    """Streaming cross-backend state over normalized rows: the pooled
    incremental frontier (unique integer keys in arrival order, rows as
    payloads), running per-backend champions, and the best overall
    score — shared by the single-store cross-backend section and the
    ``--compare`` pooled frontier, so neither materializes the pooled
    record list."""

    def __init__(self):
        self.n = 0
        self.names: set[str] = set()
        self.fi = FrontierIndex()
        self.champs: dict[str, tuple[float, dict]] = {}
        self.best: float | None = None

    def add_record(self, r: Mapping,
                   label: str | None = None) -> dict | None:
        """Feed one raw record; returns its normalized row (or ``None``
        when it does not participate)."""
        row = _norm_row(r, label)
        if row is not None:
            self.add_row(row)
        return row

    def add_row(self, row: dict) -> None:
        self.fi.insert(self.n, canonical_vector(row["norm"],
                                                NORMALIZED_OBJECTIVES),
                       payload=row)
        self.n += 1
        self.names.add(row["backend"])
        s = _norm_score(row)
        champ = self.champs.get(row["backend"])
        if champ is None or s > champ[0]:
            self.champs[row["backend"]] = (s, row)
        if self.best is None or s > self.best:
            self.best = s

    def section(self, k: int, labeled: bool = False) -> list[str]:
        """One frontier across device families: every feasible record
        mapped to the normalized objective schema, Pareto-sorted
        together."""
        lines = ["## Cross-backend frontier (normalized objectives)", ""]
        if not self.n:
            lines += ["_No normalizable feasible designs._", ""]
            return lines
        names = sorted(self.names)
        lines += [f"{self.n} feasible cells from backend(s) "
                  + ", ".join(f"`{n}`" for n in names)
                  + ", compared in normalized units: "
                  + ", ".join(f"`{s.name}` ({s.units})"
                              for s in NORMALIZED_OBJECTIVES)
                  + ". Hardware watt/dollar/peak terms come from the spec "
                    "tables in `repro.core.hw_specs`.", ""]

        payloads = {key: row for key, _, row in self.fi.front()}
        order = self.fi.diverse()
        shown = order[:len(order) if k <= 0 else k]
        cols = ((["store"] if labeled else []) + ["backend", "cell"]
                + _normalized_columns())
        rows = []
        for key in shown:
            x = payloads[key]
            rows.append(([x["label"]] if labeled else [])
                        + [f"`{x['backend']}`", f"`{x['rec']['cell_key']}`"]
                        + _normalized_values(x["norm"]))
        lines += [f"### Frontier ({len(order)} of {self.n} designs, "
                  f"crowding-distance order)", ""]
        lines += _table(cols, rows)
        if len(shown) < len(order):
            lines += ["", f"_{len(order) - len(shown)} more frontier "
                          f"designs (rerun with `--top {len(order)}`)._"]
        lines += [""]

        # per-backend champions under the default normalized scalarization
        lines += [f"### Backend champions (best by "
                  f"{dict(NORMALIZED_DEFAULT_WEIGHTS)})", ""]
        best_overall = self.best
        rows = []
        for n in names:
            score, champ = self.champs[n]
            ratio = (score / best_overall) if best_overall else 0.0
            rows.append([f"`{n}`", f"`{champ['rec']['cell_key']}`"]
                        + _normalized_values(champ["norm"])
                        + [f"{ratio:.2f}x"])
        lines += _table(["backend", "cell"] + _normalized_columns()
                        + ["vs best"], rows)
        lines += [""]
        return lines


# ---------------------------------------------------------------------------
# store comparison (--compare): winner deltas + objective trajectories
# ---------------------------------------------------------------------------


def _pct(new: float, old: float) -> str:
    if not old:
        return "n/a"
    return f"{(new - old) / old * 100:+.1f}%"


def render_compare(stores: Sequence[tuple[str, Iterable[Mapping]]], *,
                   title: str | None = None, k: int = 12) -> str:
    """Two or more (label, records) stores -> a Markdown comparison.

    The store ORDER is the trajectory: deltas are last-vs-first, so
    passing two snapshots of the same campaign shows perf drift over
    time, and passing sibling backends' stores shows which family wins
    each workload and by how much.

    Each store's records may be any iterable (e.g. a streaming
    ``iter_records()``) and is consumed exactly once: summary counts,
    trajectories, winner groups, and the pooled frontier all accumulate
    in that single pass, sharing one incremental frontier index.
    """
    stores = list(stores)
    if len(stores) < 2:
        raise ValueError("compare needs at least two stores")
    labels = [lab for lab, _ in stores]
    title = title or ("DSE store comparison — " + " vs ".join(labels))

    pooled = _NormAcc()
    summaries = []       # (label, cells, backend names, normalizable, best)
    traj: list[dict[str, float | None]] = []  # per-store objective maxima
    groups: dict[str, dict[str, dict]] = {}   # workload -> label -> best row
    for lab, recs in stores:
        n, n_norm, best = 0, 0, None
        names: set[str] = set()
        bests: dict[str, float | None] = {s.name: None
                                          for s in NORMALIZED_OBJECTIVES}
        for r in recs:
            n += 1
            names.add(record_backend(r))
            row = pooled.add_record(r, label=lab)
            if row is None:
                continue
            n_norm += 1
            s = _norm_score(row)
            if best is None or s > best:
                best = s
            for spec in NORMALIZED_OBJECTIVES:
                v = row["norm"][spec.name]
                if bests[spec.name] is None or v > bests[spec.name]:
                    bests[spec.name] = v
            g = get_backend(row["backend"]).group_key(row["rec"])
            cur = groups.setdefault(g, {})
            if lab not in cur or s > _norm_score(cur[lab]):
                cur[lab] = row
        summaries.append((lab, n, names, n_norm,
                          best if best is not None else 0.0))
        traj.append(bests)

    lines = [f"# {title}", ""]
    rows = [[lab, n, ", ".join(f"`{b}`" for b in sorted(names)), n_norm,
             best] for lab, n, names, n_norm, best in summaries]
    lines += _table(["store", "cells", "backends", "feasible (normalizable)",
                     f"best {dict(NORMALIZED_DEFAULT_WEIGHTS)}"], rows)
    lines += [""]

    # objective trajectories: best normalized value per store, in order
    lines += ["## Objective trajectories (best per store, in store order)",
              ""]
    rows = []
    for spec in NORMALIZED_OBJECTIVES:
        bests = [(t[spec.name] if t[spec.name] is not None else 0.0)
                 for t in traj]
        rows.append([f"`{spec.name}` ({spec.units})"] + bests
                    + [_pct(bests[-1], bests[0])])
    lines += _table(["objective"] + labels + ["last vs first"], rows)
    lines += [""]

    # per-workload winner deltas
    lines += ["## Per-workload winner deltas", "",
              "Best design per workload per store under the default "
              f"normalized scalarization {dict(NORMALIZED_DEFAULT_WEIGHTS)}; "
              "delta compares the LAST store against the FIRST.", ""]
    rows = []
    for g in sorted(groups):
        per_lab = groups[g]
        scores = [(_norm_score(per_lab[lab]) if lab in per_lab else None)
                  for lab in labels]
        present = [s for s in scores if s is not None]
        win_i = scores.index(max(present))
        winner = per_lab[labels[win_i]]
        delta = (_pct(scores[-1], scores[0])
                 if scores[0] is not None and scores[-1] is not None
                 else "n/a")
        rows.append([g]
                    + [f"{s:.4g}" if s is not None else "—" for s in scores]
                    + [delta, labels[win_i],
                       f"`{winner['rec']['cell_key']}`"])
    lines += _table(["workload"] + [f"{lab} tflops" for lab in labels]
                    + ["Δ last vs first", "winner", "winning cell"], rows)
    lines += [""]

    # pooled cross-backend frontier, annotated with source store
    lines += pooled.section(k, labeled=True)
    return "\n".join(lines).rstrip() + "\n"


# ---------------------------------------------------------------------------
# placement report (repro.dse.placement results)
# ---------------------------------------------------------------------------


def placement_section(result) -> list[str]:
    """Markdown section for a :class:`repro.dse.placement.PlacementResult`:
    the per-workload assignment table ({family, part, count, design
    point}), budget utilization per capped axis, and the marginal
    "next dollar / next watt" upgrade table."""
    unit = {s.name: s.units for s in NORMALIZED_OBJECTIVES}[result.objective]
    lines = [
        f"{len(result.assignments)} workload(s) placed by the "
        f"`{result.solver}` solver ({result.explored} points examined), "
        f"maximizing `{result.objective}` ({unit}) under a budget of "
        f"{result.budget.describe()}. Candidate designs per workload "
        f"(raw -> cost-dominance-pruned): "
        + ", ".join(f"{w} {raw}->{kept}"
                    for w, (raw, kept) in sorted(result.options.items()))
        + ".", ""]

    lines += ["## Assignment", ""]
    cols = ["workload", "family", "part", "count", "design point", "cell",
            f"{result.objective} ({unit})", "$/h", "W"]
    rows = []
    for a in result.assignments:
        c = a.candidate
        rows.append([a.workload, f"`{c.backend}`", c.part, c.count,
                     f"`{c.point}`", f"`{c.cell_key}`", c.value,
                     c.usd_per_hour, c.watts])
    rows.append(["**total**", "", "", "", "", "", result.total_value,
                 result.total_usd, result.total_watts])
    lines += _table(cols, rows)
    lines += [""]

    lines += ["## Budget utilization", ""]
    rows = []
    for axis, label in (("usd_per_hour", "dollars ($/h)"),
                        ("watts", "power (W)")):
        used, cap = result.utilization()[axis]
        rows.append([label, used, f"{cap:g}" if cap is not None else "—",
                     f"{used / cap:.0%}" if cap else "—"])
    lines += _table(["axis", "used", "cap", "utilization"], rows)
    lines += [""]

    lines += ["## Marginal upgrades (next dollar / next watt)", ""]
    if not result.suggestions:
        lines += ["_Every value-raising upgrade already fits in the "
                  "budget — raising it would not change this "
                  "assignment._", ""]
        return lines
    lines += ["Best rejected upgrade per workload — the cheapest budget "
              "raise that would change the answer:", ""]
    rows = []
    for s in result.suggestions:
        rows.append([s.workload, f"`{s.candidate.cell_key}`",
                     f"+{_fmt(s.gain)}", f"{s.d_usd:+.4g}",
                     f"{s.d_watts:+.4g}",
                     ", ".join(s.blocked_by) or "budget"])
    lines += _table(["workload", "upgrade to", f"+{result.objective}",
                     "+$/h", "+W", "blocked by"], rows)
    lines += [""]
    return lines


def render_placement(result, *, title: str | None = None) -> str:
    """A full Markdown placement report (one section per concern)."""
    title = title or (f"Placement — {len(result.assignments)} workload(s) "
                      f"under {result.budget.describe()}")
    lines = [f"# {title}", ""] + placement_section(result)
    return "\n".join(lines).rstrip() + "\n"


def calibration_section(calibration, stamped: int = 0,
                        stamp_fps: set[str] | None = None) -> list[str]:
    """The predicted-vs-measured error table for a fitted calibration
    (:mod:`repro.calib`): per corrected part, the fitted compute/bandwidth
    multipliers, measurement count, raw vs calibrated geometric-RMS error,
    and provenance — the error bars behind every corrected frontier claim.
    ``stamped``/``stamp_fps`` describe the store's per-record calibration
    stamps, so the section also says how many records actually carried
    corrections (and flags stamps from a DIFFERENT fit)."""
    from repro_torch.calib.fit import error_rows
    lines = ["## Calibration (predicted vs measured)", ""]
    if calibration.is_identity():
        lines += ["_Identity calibration: no corrections applied; every "
                  "evaluation used datasheet specs._", ""]
        return lines
    fp = calibration.fingerprint()
    lines += [f"{len(calibration.parts())} corrected part(s), calibration "
              f"fingerprint `{fp}`. `compute ×` / `bandwidth ×` multiply "
              f"the part's delivered rate; errors are geometric-RMS "
              f"relative error of the model against the fitted "
              f"measurements, before (`raw`) and after (`cal`) the "
              f"correction — the fit guarantees cal ≤ raw per part.", ""]
    rows = []
    for r in error_rows(calibration):
        src = r["source"] + (f" ({r['date']})" if r["date"] else "")
        rows.append([f"`{r['part']}`", r["compute_scale"], r["bw_scale"],
                     r["n"], f"{r['raw_err_pct']:.2f}",
                     f"{r['cal_err_pct']:.2f}", r["kind"], src])
    lines += _table(["part", "compute ×", "bandwidth ×", "n", "raw err %",
                     "cal err %", "kind", "source (date)"], rows)
    lines += [""]
    if stamped:
        fps = sorted(f for f in (stamp_fps or set()) if f)
        note = (f"{stamped} store record(s) were evaluated under "
                f"calibration stamp(s) "
                + ", ".join(f"`{f}`" for f in fps) + ".")
        if any(f != fp for f in fps):
            note += (" ⚠ Some stamps differ from the calibration shown "
                     "above — those records were corrected by a different "
                     "fit.")
        lines += [note, ""]
    return lines


def _bench_section(bench: Mapping) -> list[str]:
    lines = ["## Benchmark appendix (`benchmarks/run.py --json`)", ""]
    for name in sorted(bench.get("benchmarks", {})):
        rows = bench["benchmarks"][name]
        lines += [f"### `{name}`", ""]
        lines += _table(["row", "us/call", "derived"],
                        [[r["name"], f"{r['us_per_call']:.1f}",
                          f"`{r['derived']}`"] for r in rows])
        lines += [""]
    return lines


# ---------------------------------------------------------------------------
# campaign health (repro.obs events + per-record convergence traces)
# ---------------------------------------------------------------------------


def _pct_of(part: float, whole: float) -> str:
    return f"{part / whole:.0%}" if whole > 0 else "—"


def health_section(records: Sequence[Mapping],
                   events: Sequence[Mapping] | None = None,
                   k: int = 10, *, total: int | None = None) -> list[str]:
    """The campaign-health section: where the wall time went (spans),
    which workers sat idle (utilization), which cells dominated the run
    (slowest-cell table), and per-cell convergence diagnostics from the
    ``trace`` field — flagging cells that were still improving when the
    iteration cap hit, i.e. cells whose budget was too small.

    ``records`` may mix normal and quarantined (``status: "failed"``)
    records: failures feed the "Failures & retries" table (exception
    histogram, per-cell attempt counts, slowest attempts — alongside the
    ``cells.failed`` / ``cells.retried`` / ``pool.rebuilds`` counters
    when events are present) and are excluded from every other table."""
    lines = ["## Campaign health", ""]
    events = list(events or [])
    failed = [r for r in records if record_status(r) != "ok"]
    records = [r for r in records if record_status(r) == "ok"]

    if events:
        wall = campaign_wall(events)
        totals = span_totals(events)
        lines += [f"### Wall-time breakdown ({wall:.2f}s campaign wall, "
                  f"{len(events)} events)", ""]
        rows = [[f"`{name}`", st.count, f"{st.total_s:.3f}",
                 f"{st.max_s:.3f}", _pct_of(st.total_s, wall)]
                for name, st in sorted(totals.items(),
                                       key=lambda kv: -kv[1].total_s)]
        lines += _table(["span", "count", "total s", "max s",
                         "% of wall"], rows)
        lines += [""]

        util = worker_utilization(events)
        if util:
            mean = sum(r["util"] for r in util.values()) / len(util)
            lines += [f"### Worker utilization (mean {mean:.0%} over "
                      f"{len(util)} process(es))", ""]
            rows = [[f"`{proc}`", r["cells"], f"{r['busy_s']:.3f}",
                     f"{r['util']:.0%}"]
                    for proc, r in sorted(util.items())]
            lines += _table(["process", "cells", "busy s", "utilization"],
                            rows)
            lines += ["", "_Utilization is `cell.eval` busy time over the "
                          "campaign wall; low values mean workers idled "
                          "(too few cells, or one straggler cell)._", ""]

        slow = slowest_spans(events, k=k)
        if slow:
            lines += [f"### Slowest cells (top {len(slow)} by `cell.eval` "
                      f"time)", ""]
            rows = [[f"`{e.get('attrs', {}).get('cell', '?')}`",
                     f"{e.get('dur', 0.0):.3f}",
                     _pct_of(e.get("dur", 0.0), wall),
                     f"`{e.get('proc', '?')}`"] for e in slow]
            lines += _table(["cell", "eval s", "% of wall", "process"], rows)
            lines += [""]

        counts = counter_totals(events)
        if counts:
            lines += ["### Counters", ""]
            lines += _table(["counter", "total"],
                            [[f"`{n}`", f"{v:g}"]
                             for n, v in sorted(counts.items())])
            lines += [""]

    retried = [r for r in records
               if isinstance(r.get("resilience"), Mapping)]
    if failed or retried:
        lines += [f"### Failures & retries ({len(failed)} quarantined, "
                  f"{len(retried)} retried-then-ok cell(s))", ""]
        if failed:
            hist: dict[str, int] = {}
            for r in failed:
                et = str(r.get("error_type", "?"))
                hist[et] = hist.get(et, 0) + 1
            lines += _table(["exception", "quarantined cells"],
                            [[f"`{et}`", n]
                             for et, n in sorted(hist.items())])
            lines += [""]
            rows = []
            for r in sorted(failed, key=lambda r: r.get("cell_key", "")):
                log = r.get("attempt_log") or []
                outcomes = ",".join(str(a.get("outcome", "?"))
                                    for a in log) or "—"
                last = (r.get("error") or "").strip().splitlines()
                rows.append([f"`{r.get('cell_key', '?')}`",
                             f"`{r.get('error_type', '?')}`",
                             r.get("attempts", len(log)), outcomes,
                             last[-1][:80] if last else "—"])
            lines += _table(["cell", "exception", "attempts", "outcomes",
                             "last error"], rows)
            lines += [""]
        attempts = []
        for r in failed + retried:
            log = (r.get("attempt_log")
                   or r.get("resilience", {}).get("attempt_log") or [])
            for a in log:
                attempts.append((float(a.get("duration_s", 0.0)),
                                 r.get("cell_key", "?"),
                                 a.get("attempt", "?"),
                                 a.get("outcome", "?")))
        attempts.sort(key=lambda t: (-t[0], t[1]))
        if attempts:
            lines += [f"### Slowest attempts (top {min(k, len(attempts))} "
                      f"across failed/retried cells)", ""]
            lines += _table(["cell", "attempt", "outcome", "duration s"],
                            [[f"`{c}`", n, o, f"{d:.3f}"]
                             for d, c, n, o in attempts[:k]])
            lines += [""]

    traced = [r for r in records if isinstance(r.get("trace"), Mapping)]
    if traced:
        n_all = total if total is not None else len(records)
        lines += [f"### Convergence diagnostics ({len(traced)} of "
                  f"{n_all} cells carry a `trace`)", ""]
        rows = []
        capped = []
        for r in sorted(traced, key=lambda r: r["cell_key"]):
            t = r["trace"]
            stop = t.get("stop_reason", "?")
            if stop == "iteration_cap":
                capped.append(r["cell_key"])
                stop = "**iteration_cap**"
            rows.append([f"`{r['cell_key']}`", t.get("engine", "?"), stop,
                         t.get("iterations", "?"), t.get("evaluations", "?"),
                         t.get("cache_hits", "?"),
                         _fmt(t.get("final_delta", 0.0))])
        lines += _table(["cell", "engine", "stop", "iters", "evals",
                         "cache hits", "final Δ"], rows)
        lines += [""]
        if capped:
            lines += [f"⚠ {len(capped)} cell(s) hit the iteration cap while "
                      f"still within the improvement patience — the search "
                      f"was still moving when it was cut off. Consider "
                      f"rerunning with a higher `--iterations`: "
                      + ", ".join(f"`{c}`" for c in capped) + ".", ""]
        else:
            lines += ["All traced searches stopped on their own terms "
                      "(converged or exhaustive) — the iteration budget "
                      "was sufficient.", ""]

        by_engine: dict[str, list[Mapping]] = {}
        for r in traced:
            t = r["trace"]
            by_engine.setdefault(str(t.get("engine", "?")), []).append(t)
        lines += [f"### Per-engine convergence ({len(by_engine)} engine(s) "
                  f"across the traced cells)", ""]
        rows = []
        for eng in sorted(by_engine):
            ts = by_engine[eng]
            stops: dict[str, int] = {}
            for t in ts:
                s = str(t.get("stop_reason", "?"))
                stops[s] = stops.get(s, 0) + 1
            stop_s = ", ".join(f"{s}×{n}" for s, n in sorted(stops.items()))
            evals = sum(int(t.get("evaluations", 0)) for t in ts)
            screened = sum(int(t.get("screened", 0)) for t in ts)
            iters = sum(int(t.get("iterations", 0)) for t in ts) / len(ts)
            fits = [t["best_fitness"] for t in ts if "best_fitness" in t]
            rows.append([f"`{eng}`", len(ts), stop_s, f"{iters:.1f}",
                         evals, screened if screened else "—",
                         _fmt(max(fits)) if fits else "—"])
        lines += _table(["engine", "cells", "stop reasons", "mean iters",
                         "evals", "screened", "best fitness"], rows)
        lines += ["", "_`screened` counts candidates a multi-fidelity "
                      "engine triaged through the cheap vectorized "
                      "relaxation; they never touch the full analytical "
                      "models and are not part of `evals`._", ""]

    if not events and not traced and not failed:
        lines += ["_No telemetry: the store records carry no `trace` field "
                  "and no events file was found. Re-run the campaign with "
                  "`--trace` to populate both._", ""]
    return lines


def render_report(records: Iterable[Mapping], *,
                  title: str = "DSE campaign report",
                  bench: Mapping | None = None, k: int = 12,
                  events: Sequence[Mapping] | None = None,
                  calibration=None) -> str:
    """Records (any mix of backends) -> a Markdown report string.

    ``records`` may be any iterable — typically a streaming
    ``CampaignStore.iter_records()`` — and is consumed in ONE pass: every
    section reads off the per-backend / cross-backend accumulators, so
    memory stays O(frontier + winners), not O(records). Only records
    carrying a convergence ``trace`` are retained (for the health
    tables).

    ``k`` caps each frontier table at the k most-spread designs
    (NSGA-II rank + crowding order); ``k <= 0`` means no cap.
    ``events`` (merged ``repro.obs`` events, e.g. from
    ``<store>.events.jsonl``) adds the campaign-health section; records
    with a ``trace`` field add convergence diagnostics even without
    events.

    ``calibration`` (a :class:`repro.calib.Calibration`) appends the
    predicted-vs-measured error table (:func:`calibration_section`), so
    the report's frontier claims carry the model's measured error bars;
    per-record calibration stamps are counted either way.
    """
    accs: dict[str, _BackendAcc] = {}
    norm = _NormAcc()
    traced: list[Mapping] = []
    failures: list[Mapping] = []
    total = 0
    stamped, stamp_fps = 0, set()
    for r in records:
        total += 1
        name = record_backend(r)
        acc = accs.get(name)
        if acc is None:
            acc = accs[name] = _BackendAcc(name)
        acc.add(r)
        if record_status(r) != "ok":
            # quarantined: counted by the accumulator, retained only for
            # the health section's failure tables
            failures.append(r)
            continue
        norm.add_record(r)
        if isinstance(r.get("trace"), Mapping):
            traced.append(r)
        info = r.get("calibration")
        if isinstance(info, Mapping):
            stamped += 1
            stamp_fps.add(str(info.get("fingerprint", "")))

    lines = [f"# {title}", "",
             f"{total} campaign cells across "
             f"{len(accs)} backend(s): "
             + ", ".join(f"`{n}`" for n in sorted(accs)) + ".", ""]
    for name in sorted(accs):
        acc = accs[name]
        if not acc.known:
            lines += [f"## Backend `{name}` — {acc.count} cells "
                      f"(unknown backend; skipped)", ""]
            continue
        lines += acc.section(k)
    if len([n for n in accs if accs[n].known]) > 1:
        lines += norm.section(k)
    if calibration is not None:
        lines += calibration_section(calibration, stamped, stamp_fps)
    elif stamped:
        fps = sorted(f for f in stamp_fps if f)
        lines += ["## Calibration (predicted vs measured)", "",
                  f"{stamped} record(s) carry calibration stamp(s) "
                  + ", ".join(f"`{f}`" for f in fps)
                  + " but no calibration file was supplied — rerun with "
                    "`--calibration <file>` to render the error table.", ""]
    if events or traced or failures:
        lines += health_section(traced + failures, events,
                                k=min(k, 10) if k > 0 else 10, total=total)
    if bench:
        lines += _bench_section(bench)
    return "\n".join(lines).rstrip() + "\n"


# ---------------------------------------------------------------------------
# selftest fixture
# ---------------------------------------------------------------------------


def fixture_records() -> list[dict]:
    """A tiny deterministic three-backend store: enough shape variety to
    exercise frontier extraction, crowding order, winner grouping,
    trade-off tables, and the cross-backend normalized frontier without
    running any search."""
    recs = []
    fpga_pts = [  # (net, h, fpga, ips, gops, lat_ms, eff, bram, feasible)
        ("vgg16", 224, "ku115", 145.0, 4220.0, 6.9, 0.764, 1800, True),
        ("vgg16", 224, "zcu102", 66.0, 1930.0, 15.2, 0.771, 1100, True),
        ("vgg16", 64, "ku115", 1630.0, 3950.0, 0.61, 0.716, 1350, True),
        ("vgg16", 64, "zcu102", 760.0, 1840.0, 1.31, 0.733, 960, True),
        ("alexnet", 0, "ku115", 2250.0, 3280.0, 0.44, 0.594, 820, True),
        ("alexnet", 0, "zcu102", 990.0, 1450.0, 1.01, 0.577, 640, False),
    ]
    for i, (net, h, fpga, ips, gops, lat, eff, bram, ok) \
            in enumerate(fpga_pts):
        size = f"{h}x{h}" if h else "native"
        # one deliberately iteration-capped cell (index 0) so health
        # reports exercise the "still improving at the cap" flag; one
        # multi-fidelity cell (index 2) so the per-engine table shows a
        # `screened` count alongside the paper's PSO
        capped = i == 0
        hyperband = i == 2
        recs.append({
            "schema": 1,
            "cell_key": f"net={net}|in={size}|fpga={fpga}|prec=16|bmax=1",
            "cell": {"net": net, "h": h, "w": h, "fpga": fpga,
                     "precision": 16, "batch_max": 1},
            "rav": {"sp": 4, "batch": 1, "f_dsp": 0.9, "f_bram": 0.8,
                    "f_bw": 0.7},
            "objectives": {"throughput_ips": ips, "gops": gops,
                           "latency_s": lat / 1e3, "dsp_eff": eff,
                           "bram_used": float(bram), "feasible": ok},
            "search": {"base_seed": 0, "population": 20, "iterations": 30,
                       "weights": None},
            "evaluations": 600,
            "trace": {
                "schema": 1,
                "engine": "hyperband" if hyperband else "pso",
                "stop_reason": "iteration_cap" if capped else "converged",
                "iterations": 30 if capped else 10 + i,
                "evaluations": 130 if hyperband else 600,
                "cache_hits": 40 + 7 * i,
                "best_fitness": ips,
                "final_delta": 1.25 if capped else 0.0,
                "history": [round(ips * f, 6)
                            for f in (0.82, 0.97, 1.0)],
                **({"screened": 4096} if hyperband else {}),
            },
        })
    # one retried-then-ok cell (index 3) and one quarantined cell so the
    # health report's "Failures & retries" section renders byte-stably
    # from the fixture alone — same hand-written-durations discipline as
    # fixture_events()
    recs[3]["resilience"] = {
        "attempts": 2,
        "retries": 1,
        "attempt_log": [
            {"attempt": 1, "outcome": "error", "duration_s": 0.021,
             "error_type": "RuntimeError"},
            {"attempt": 2, "outcome": "ok", "duration_s": 0.34,
             "error_type": None},
        ],
    }
    recs.append({
        "schema": 1,
        "status": "failed",
        "quarantine_schema": 1,
        "cell_key": "net=alexnet|in=native|fpga=ku115|prec=8|bmax=1",
        "cell": {"net": "alexnet", "h": 0, "w": 0, "fpga": "ku115",
                 "precision": 8, "batch_max": 1},
        "search": {"base_seed": 0, "population": 20, "iterations": 30,
                   "weights": None},
        "error_type": "ValueError",
        "error": "Traceback (most recent call last):\n"
                 "  ...\n"
                 "ValueError: injected[raise-permanent] "
                 "net=alexnet|in=native|fpga=ku115|prec=8|bmax=1 "
                 "(attempt 1)",
        "attempts": 1,
        "attempt_log": [
            {"attempt": 1, "outcome": "error", "duration_s": 0.012,
             "error_type": "ValueError"},
        ],
        "evaluations": 0,
    })
    tpu_pts = [  # (arch, shape, chips, remat, mb, dp, tp, step, mfu, hbm, ok)
        ("starcoder2-3b", "train_4k", 8, "full", 2, 8, 1, 18.1, 0.52,
         10.4, True),
        ("starcoder2-3b", "train_4k", 16, "full", 2, 16, 1, 9.1, 0.51,
         5.2, True),
        ("starcoder2-3b", "train_4k", 16, "none", 2, 16, 1, 6.8, 0.58,
         24.7, False),
        ("starcoder2-3b", "decode_32k", 8, "none", 1, 8, 1, 0.021, 0.03,
         15.7, True),
        ("xlstm-350m", "train_4k", 8, "full", 1, 8, 1, 1.28, 0.47,
         2.4, True),
        ("xlstm-350m", "decode_32k", 8, "none", 1, 8, 1, 0.00064, 0.06,
         0.4, True),
    ]
    for arch, shape, chips, remat, mb, dp, tp, step, mfu, hbm, ok in tpu_pts:
        recs.append({
            "schema": 1,
            "backend": "tpu",
            "cell_key": (f"arch={arch}|shape={shape}|chips={chips}"
                         f"|remat={remat}|mb={mb}"),
            "cell": {"arch": arch, "shape": shape, "chips": chips,
                     "remat": remat, "microbatches": mb},
            "plan": {"dp": dp, "tp": tp, "bound": "compute"},
            "objectives": {"step_time_s": step, "mfu": mfu, "hbm_gib": hbm,
                           "chips": float(chips), "feasible": ok},
            "search": {"weights": None},
            "evaluations": 4,
            "trace": {"schema": 1, "engine": "enumeration",
                      "stop_reason": "exhaustive", "iterations": 4,
                      "evaluations": 4, "cache_hits": 0},
        })
    cuda_pts = [  # (arch, shape, gpu, n, remat, mb, dp, tp,
                  #  step, mfu, hbm, watts, ok)
        ("starcoder2-3b", "train_4k", "a100-80g", 8, "full", 2, 8, 1,
         11.5, 0.62, 10.4, 3200.0, True),
        ("starcoder2-3b", "train_4k", "h100", 8, "full", 2, 8, 1,
         3.7, 0.55, 10.4, 5600.0, True),
        ("starcoder2-3b", "train_4k", "a100-40g", 8, "none", 1, 8, 1,
         2.9, 0.71, 41.0, 3200.0, False),
        ("starcoder2-3b", "decode_32k", "h100", 8, "none", 1, 8, 1,
         0.009, 0.04, 14.9, 5600.0, True),
        ("xlstm-350m", "train_4k", "a100-40g", 8, "full", 1, 8, 1,
         0.92, 0.49, 2.4, 3200.0, True),
    ]
    for arch, shape, gpu, n, remat, mb, dp, tp, step, mfu, hbm, w, ok \
            in cuda_pts:
        recs.append({
            "schema": 1,
            "backend": "cuda",
            "cell_key": (f"arch={arch}|shape={shape}|gpu={gpu}|gpus={n}"
                         f"|remat={remat}|mb={mb}"),
            "cell": {"arch": arch, "shape": shape, "gpu": gpu, "gpus": n,
                     "remat": remat, "microbatches": mb},
            "plan": {"dp": dp, "tp": tp, "bound": "compute"},
            "objectives": {"step_time_s": step, "mfu": mfu, "hbm_gib": hbm,
                           "gpus": float(n), "watts": w, "feasible": ok},
            "search": {"weights": None},
            "evaluations": 4,
            "trace": {"schema": 1, "engine": "enumeration",
                      "stop_reason": "exhaustive", "iterations": 4,
                      "evaluations": 4, "cache_hits": 0},
        })
    return recs


def fixture_events() -> list[dict]:
    """A tiny deterministic merged-events stream matching two of the
    fixture FPGA cells: a campaign span over two spawn workers, each
    with queue-wait / cell.run / cell.eval spans, store appends, pool
    gauges, and counters. Hand-written timestamps (no clocks), so the
    rendered health report is byte-stable — the committed
    ``docs/reports/example_health.md`` drift test depends on that."""
    a = "net=vgg16|in=64x64|fpga=ku115|prec=16|bmax=1"
    b = "net=vgg16|in=64x64|fpga=zcu102|prec=16|bmax=1"

    def ev(kind, name, proc, ts, seq, **fields):
        attrs = fields.pop("attrs", {})
        return {"schema": 1, "kind": kind, "name": name, "proc": proc,
                "ts": ts, "seq": seq, **fields, "attrs": attrs}

    return sorted([
        ev("gauge", "pool.inflight", "main", 100.05, 0, value=2.0),
        ev("span", "queue.wait", "worker-1", 100.4, 0, dur=0.35, depth=0,
           attrs={"cell": a}),
        ev("span", "cell.eval", "worker-1", 100.45, 1, dur=3.6, depth=1,
           attrs={"cell": a}),
        ev("span", "cell.run", "worker-1", 100.4, 2, dur=3.7, depth=0,
           attrs={"cell": a, "backend": "fpga"}),
        ev("span", "queue.wait", "worker-2", 100.5, 0, dur=0.45, depth=0,
           attrs={"cell": b}),
        ev("span", "cell.eval", "worker-2", 100.55, 1, dur=5.8, depth=1,
           attrs={"cell": b}),
        ev("span", "cell.run", "worker-2", 100.5, 2, dur=5.9, depth=0,
           attrs={"cell": b, "backend": "fpga"}),
        ev("span", "store.append", "main", 104.2, 1, dur=0.012, depth=1,
           attrs={"cell": a}),
        ev("counter", "cells.done", "main", 104.25, 2, value=1),
        ev("gauge", "pool.inflight", "main", 104.3, 3, value=1.0),
        ev("span", "store.append", "main", 106.5, 4, dur=0.011, depth=1,
           attrs={"cell": b}),
        ev("counter", "cells.done", "main", 106.55, 5, value=1),
        ev("gauge", "pool.inflight", "main", 106.6, 6, value=0.0),
        ev("span", "campaign", "main", 100.0, 7, dur=6.65, depth=0,
           attrs={"backend": "fpga", "cells": 2, "todo": 2, "workers": 2}),
    ], key=lambda e: (e["ts"], e["proc"], e["seq"]))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse.report",
        description="Render a Markdown campaign report from a JSONL store "
                    "(plus optional benchmarks/run.py --json output).")
    ap.add_argument("store", nargs="?", default=None,
                    help="campaign JSONL store (any backend or a mix)")
    ap.add_argument("--compare", nargs="+", default=None, metavar="STORE",
                    help="compare mode: two or more stores, in trajectory "
                         "order — renders per-workload winner deltas, "
                         "normalized objective trajectories, and a pooled "
                         "cross-backend frontier")
    ap.add_argument("--bench", default=None, metavar="JSON",
                    help="benchmarks/run.py --json output to append")
    ap.add_argument("--calibration", default=None, metavar="JSON",
                    help="fitted calibration (python -m repro.calib fit) — "
                         "appends the predicted-vs-measured error table "
                         "so frontier claims carry error bars")
    ap.add_argument("--out", default=None, metavar="MD",
                    help="output path (default: docs/reports/<store-stem>.md)")
    ap.add_argument("--title", default=None)
    ap.add_argument("--top", type=int, default=12,
                    help="frontier rows per backend, crowding-ordered "
                         "(<= 0: all)")
    ap.add_argument("--selftest", action="store_true",
                    help="render the built-in fixture store and exit "
                         "(the CI docs check); writes nothing")
    args = ap.parse_args(argv)

    if args.selftest:
        fix = fixture_records()
        md = render_report(fix, title="selftest campaign", k=args.top,
                           events=fixture_events())
        half = [r for r in fix if r.get("backend") != "cuda"]
        cmp_md = render_compare([("tpu+fpga", half),
                                 ("all", fix)], k=args.top)
        for must in ("Pareto frontier", "Backend `fpga`", "Backend `tpu`",
                     "Backend `cuda`", "Per-workload winners",
                     "Objective trade-offs", "Cross-backend frontier",
                     "Backend champions", "Campaign health",
                     "Wall-time breakdown", "Worker utilization",
                     "Slowest cells", "Convergence diagnostics",
                     "Per-engine convergence", "iteration cap",
                     "Failures & retries", "Slowest attempts"):
            if must not in md:
                raise SystemExit(f"selftest: section {must!r} missing "
                                 f"from rendered report")
        if "Calibration" in md:
            raise SystemExit("selftest: uncalibrated fixture report must "
                             "not contain a Calibration section")
        for must in ("Per-workload winner deltas", "Objective trajectories",
                     "Cross-backend frontier"):
            if must not in cmp_md:
                raise SystemExit(f"selftest: section {must!r} missing "
                                 f"from compare report")
        from repro_torch.calib import fit_corrections, fixture_measurements
        cal = fit_corrections(fixture_measurements())
        cal_md = render_report(fix, title="selftest calibrated campaign",
                               k=args.top, calibration=cal)
        if "## Calibration (predicted vs measured)" not in cal_md:
            raise SystemExit("selftest: calibration error table missing "
                             "from calibrated report")
        for part in cal.parts():
            c = cal.correction(part)
            if f"`{part}`" not in cal_md:
                raise SystemExit(f"selftest: part {part!r} missing from "
                                 f"calibration error table")
            if c.cal_err_pct > c.raw_err_pct + 1e-9:
                raise SystemExit(f"selftest: calibrated error exceeds raw "
                                 f"for {part!r}")
        print(f"selftest OK: rendered {len(md)} + {len(cmp_md)} + "
              f"{len(cal_md)} chars, all sections present")
        return 0

    if args.compare:
        if args.bench:
            ap.error("--bench only applies to single-store reports, "
                     "not --compare")
        if args.store:
            args.compare = [args.store] + args.compare
        if len(args.compare) < 2:
            ap.error("--compare needs at least two stores")
        stores, labels = [], []
        for path in args.compare:
            s = open_store(path)
            if not len(s):
                ap.error(f"store {path} is empty or missing")
            stem = Path(path).stem
            n_seen = sum(1 for l in labels if l.split("#")[0] == stem)
            lab = stem if not n_seen else f"{stem}#{n_seen + 1}"
            labels.append(lab)
            stores.append((lab, s.iter_records()))
        md = render_compare(stores, title=args.title, k=args.top)
        out = Path(args.out) if args.out else \
            DEFAULT_REPORT_DIR / ("compare_" + "_vs_".join(
                Path(p).stem for p in args.compare[:2]) + ".md")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(md)
        print(f"compare report -> {out} ({len(md)} chars, "
              f"{len(stores)} stores)")
        return 0

    if not args.store:
        ap.error("a store path is required (or use --selftest / --compare)")
    store = open_store(args.store)
    if not len(store):
        ap.error(f"store {args.store} is empty or missing")
    bench = None
    if args.bench:
        with open(args.bench) as f:
            bench = json.load(f)
    calibration = None
    if args.calibration:
        from repro_torch.calib import Calibration
        calibration = Calibration.load(args.calibration)
    # merged telemetry from a --trace run rides next to the store; pick
    # it up automatically so traced campaigns get the health section
    ev_path = events_path_for(args.store)
    events = load_events(ev_path) if ev_path.exists() else None
    title = args.title or f"DSE campaign report — {Path(args.store).name}"
    md = render_report(store.iter_records(), title=title, bench=bench,
                       k=args.top, events=events, calibration=calibration)
    out = Path(args.out) if args.out else \
        DEFAULT_REPORT_DIR / f"{Path(args.store).stem}.md"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(md)
    print(f"report -> {out} ({len(md)} chars, "
          f"{len(store)} cells, backends: {', '.join(store.backends())}"
          + (f", {len(events)} telemetry events" if events else "") + ")")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
