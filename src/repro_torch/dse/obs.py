"""Telemetry inspector CLI: summarize, validate, and export the
``repro.obs`` events a ``--trace`` campaign leaves next to its store.

    python -m repro.dse.obs results/dse.jsonl            # text summary
    python -m repro.dse.obs results/dse.jsonl --validate # schema check
    python -m repro.dse.obs results/dse.jsonl --chrome   # trace export
    python -m repro.dse.obs --fixture --out docs/reports/example_health.md

The summary is the plain-text twin of the report's campaign-health
section: per-backend store stats (cells, feasible, incremental-frontier
size — streamed off ``CampaignStore.iter_records``, never materialized),
wall-time breakdown by span, worker utilization, slowest cells, and
counter totals. ``--validate`` checks every event against
the v1 schema and exits non-zero on any problem (the CI docs job runs
it on a freshly traced smoke campaign). ``--chrome`` writes the
Chrome trace-event export (load in Perfetto / ``chrome://tracing``).
``--fixture`` renders the deterministic example health report that is
committed at ``docs/reports/example_health.md`` and drift-checked by
the test suite.

Events are looked up as the merged ``<store>.events.jsonl`` first,
falling back to re-merging the ``<store>.events/`` sidecar directory —
so the inspector also works on a campaign that was killed before its
parent merged the sidecars.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.obs import (campaign_wall, chrome_path_for, chrome_trace,
                       counter_totals, events_dir_for, events_path_for,
                       load_events, merge_events, slowest_spans, span_totals,
                       validate_events, worker_utilization)


def events_for_store(store_path: str) -> list[dict]:
    """Merged events for a store: the ``.events.jsonl`` file if the
    campaign parent wrote it, else a fresh merge of the sidecar dir
    (covers runs killed before the final merge). Empty list if the
    campaign was never traced."""
    merged = events_path_for(store_path)
    if merged.exists():
        return load_events(merged)
    d = events_dir_for(store_path)
    if d.is_dir():
        return merge_events(d)
    return []


def example_health_md() -> str:
    """The deterministic example health report (fixture records +
    fixture events through the real renderer). Committed at
    ``docs/reports/example_health.md``; a test re-renders and diffs it,
    so the committed doc can never drift from the code."""
    from .report import fixture_events, fixture_records, health_section
    lines = [
        "# Example campaign health report",
        "",
        "Deterministic output of `python -m repro.dse.obs --fixture`: the",
        "campaign-health section a traced run (`--trace`) adds to",
        "`python -m repro.dse.report <store>`, rendered from the built-in",
        "fixture store and a hand-written event stream. Regenerate with:",
        "",
        "    python -m repro.dse.obs --fixture --out "
        "docs/reports/example_health.md",
        "",
    ] + health_section(fixture_records(), fixture_events())
    return "\n".join(lines).rstrip() + "\n"


def print_store_stats(store) -> None:
    """Per-backend store stats in one streaming pass per backend: cell
    and feasible counts plus the incremental Pareto frontier size —
    ``iter_records()`` + :class:`repro.dse.frontier.FrontierIndex`, so a
    100k-record store summarizes without a record list in memory."""
    from .backends import BACKENDS, get_backend
    from .frontier import FrontierIndex
    layout = "sharded" if store.sharded else "v1"
    print(f"\n-- store ({layout}, {len(store)} cells) --")
    for bk in store.backends():
        n = feas = 0
        be = get_backend(bk) if bk in BACKENDS else None
        fi = FrontierIndex()
        for rec in store.iter_records(bk):
            n += 1
            if rec.get("objectives", {}).get("feasible"):
                feas += 1
                if be is not None:
                    fi.insert(rec["cell_key"],
                              be.canonical(rec["objectives"]))
        front = fi.front_size() if be is not None else "?"
        print(f"{bk:<8} {n:>6} cells  {feas:>6} feasible  "
              f"frontier {front}")


def print_summary(events: list[dict], top: int) -> None:
    wall = campaign_wall(events)
    print(f"{len(events)} events, campaign wall {wall:.2f}s")

    print("\n-- wall-time breakdown --")
    print(f"{'span':<16} {'count':>5} {'total s':>9} {'max s':>9} "
          f"{'% wall':>7}")
    for name, st in sorted(span_totals(events).items(),
                           key=lambda kv: -kv[1].total_s):
        pct = f"{st.total_s / wall:.0%}" if wall > 0 else "—"
        print(f"{name:<16} {st.count:>5} {st.total_s:>9.3f} "
              f"{st.max_s:>9.3f} {pct:>7}")

    util = worker_utilization(events)
    if util:
        print("\n-- worker utilization (cell.eval busy / campaign wall) --")
        for proc, row in sorted(util.items()):
            print(f"{proc:<16} {row['cells']:>3} cells "
                  f"{row['busy_s']:>9.3f}s busy  {row['util']:>5.0%}")

    slow = slowest_spans(events, k=top)
    if slow:
        print(f"\n-- slowest cells (top {len(slow)} by cell.eval) --")
        for e in slow:
            print(f"{e.get('dur', 0.0):>9.3f}s  "
                  f"{e.get('attrs', {}).get('cell', '?')}  "
                  f"[{e.get('proc', '?')}]")

    counts = counter_totals(events)
    if counts:
        print("\n-- counters --")
        for name, v in sorted(counts.items()):
            print(f"{name:<24} {v:g}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse.obs",
        description="Inspect the telemetry of a traced DSE campaign: "
                    "summarize spans/counters, validate events against "
                    "the schema, export a Chrome trace.")
    ap.add_argument("store", nargs="?", default=None,
                    help="campaign JSONL store whose telemetry to read "
                         "(<store>.events.jsonl or <store>.events/)")
    ap.add_argument("--validate", action="store_true",
                    help="check every event against the v1 schema; "
                         "non-zero exit on any problem")
    ap.add_argument("--chrome", nargs="?", const="", default=None,
                    metavar="JSON",
                    help="write the Chrome trace-event export (default "
                         "path: <store>.trace.json)")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the slowest-cell table")
    ap.add_argument("--fixture", action="store_true",
                    help="render the deterministic example health report "
                         "instead of reading a store")
    ap.add_argument("--out", default=None, metavar="MD",
                    help="with --fixture: write the Markdown here instead "
                         "of stdout")
    args = ap.parse_args(argv)

    if args.fixture:
        md = example_health_md()
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(md)
            print(f"example health report -> {out} ({len(md)} chars)")
        else:
            print(md, end="")
        return 0

    if not args.store:
        ap.error("a store path is required (or use --fixture)")
    events = events_for_store(args.store)
    if not events:
        ap.error(f"no telemetry for {args.store}: neither "
                 f"{events_path_for(args.store)} nor a "
                 f"{events_dir_for(args.store)}/ sidecar dir — run the "
                 f"campaign with --trace")

    rc = 0
    if args.validate:
        problems = validate_events(events)
        for p in problems:
            print(f"INVALID: {p}")
        print(f"validate: {len(events)} events, {len(problems)} problem(s)")
        rc = 1 if problems else 0

    from .store import open_store, sharded_dir_for
    store_p = Path(args.store)
    if store_p.exists() or sharded_dir_for(store_p).is_dir():
        print_store_stats(open_store(args.store))

    print_summary(events, args.top)

    if args.chrome is not None:
        out = Path(args.chrome) if args.chrome else \
            chrome_path_for(args.store)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(chrome_trace(events)))
        print(f"\nchrome trace -> {out}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
