"""CLI for the port's DSE campaigns: ranked report + Pareto frontier
dump, for any registered backend (the port's copy of
``repro/dse/cli.py``). ``--backend fpga`` is the default and the paper's
flow; ``--backend tpu`` sweeps the analytic TPU planner; ``--backend
cuda`` sweeps the GPU roofline with the GPU part as a campaign axis.
``--device`` replaces the reference's ``--jax-screen``: it names where
hyperband's cross-cell rung-0 screen of the fpga cells runs (default: the
card).

    python -m repro_torch.dse.campaign --nets vgg16,alexnet \\
        --fpgas ku115,zcu102 --precisions 16,8 --searcher hyperband \\
        --store results/dse.jsonl --frontier-json results/frontier.json

    python -m repro_torch.dse.campaign --nets vgg16 --searcher hyperband \\
        --searcher-config screen=256,survivors=4 --device cpu \\
        --store /tmp/t.jsonl

    python -m repro_torch.dse.campaign --backend tpu --archs starcoder2-3b \\
        --shapes train_4k,decode_32k --chips 8,16,32 \\
        --store results/dse_tpu.jsonl

    python -m repro_torch.dse.campaign --backend cuda --archs starcoder2-3b \\
        --shapes train_4k --gpus 8,16 --gpu-types a100-80g,h100 \\
        --store results/dse_cuda.jsonl

Stores render to Markdown with ``python -m repro_torch.dse.report
<store>``; two stores (e.g. the tpu and cuda campaigns above) compare
with ``python -m repro_torch.dse.report --compare A.jsonl B.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.core.search import searcher_names

from .backends import (BACKENDS, get_backend, parse_inputs,  # noqa: F401
                       parse_searcher_config, parse_weights)
from .campaign import CampaignReport, run_campaign
from .resilience import RetryPolicy


def print_report(report: CampaignReport, weights: dict | None,
                 top: int) -> list[dict]:
    """Print the ranked + frontier tables; returns the first Pareto front
    (crowding-distance order, extremes first) so callers can reuse it
    without redoing the dominance sort."""
    be = report._backend()
    print(f"\n== campaign[{be.name}]: {len(report.cells)} cells "
          f"({report.new_cells} new, {report.reused_cells} reused; "
          f"{report.new_evaluations} new evaluations, "
          f"{report.wall_time_s:.1f}s) ==")

    shown = dict(weights or be.default_weights)
    print(f"\n-- top {top} by scalarized objective {shown} --")
    print(be.table_header())
    for rec in report.ranked(weights)[:top]:
        print(be.table_row(rec))

    # print the frontier as a diversity-ordered spread (rank, then
    # crowding distance) so a truncated read-off still covers the
    # surface — read off the report's incremental frontier index
    fi = report.frontier_index()
    front = [fi.payload(key) for key in fi.diverse()]
    names = ", ".join(f"{s.name}[{'max' if s.maximize else 'min'}]"
                      for s in be.objectives)
    print(f"\n-- Pareto frontier: {len(front)} of "
          f"{len(fi)} feasible designs ({names}) --")
    print(be.table_header())
    for rec in front:
        print(be.table_row(rec))
    return front


def main(argv: list[str] | None = None) -> CampaignReport:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse.campaign",
        description="Batch multi-objective DSE campaign over a backend's "
                    "axis grid (fpga: net x input x FPGA x precision x "
                    "batch cap; tpu: arch x shape x chips x remat x "
                    "microbatches; cuda: the tpu axes with a GPU-part "
                    "axis instead of chips).")
    ap.add_argument("--backend", choices=sorted(BACKENDS), default="fpga",
                    help="device family to sweep (default: fpga, the "
                         "paper's flow)")
    for be in BACKENDS.values():
        be.add_axis_arguments(ap)
    ap.add_argument("--store", default=None,
                    help="JSONL result store (resumable/memoized; default "
                         "per backend, e.g. results/dse_campaign.jsonl). "
                         "A <name>.d path selects the sharded v2 layout "
                         "(see docs/store.md)")
    ap.add_argument("--shard", default="0",
                    help="shard id THIS process appends to when --store "
                         "is sharded — give each concurrent campaign host "
                         "its own id and they share one store without "
                         "lock contention")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool width; 0 = one per CPU")
    ap.add_argument("--population", type=int, default=20)
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed; per-cell seeds derive from it "
                         "(fpga only; the tpu planner is deterministic)")
    ap.add_argument("--searcher", choices=searcher_names(), default="pso",
                    help="search engine per fpga cell (default: pso, the "
                         "paper's Algorithm 1; hyperband = multi-fidelity "
                         "successive halving). Stored in the resume-match "
                         "config: a store written by one engine re-runs "
                         "under another instead of mixing results")
    ap.add_argument("--searcher-config", default="",
                    help="engine config overrides, e.g. "
                         "screen=2048,survivors=8 (fields of the engine's "
                         "config dataclass; see docs/search.md)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where every cell's hyperband rung-0 screen runs, "
                         "in ONE cross-cell call (fpga backend + "
                         "--searcher hyperband only; default: cuda; "
                         "bit-identical to the per-cell NumPy screen; "
                         "cuda without a card is an error, not a "
                         "fallback)")
    ap.add_argument("--calibration", default=None, metavar="JSON",
                    help="apply a fitted calibration (python -m repro.calib "
                         "fit) to every hardware spec the cells evaluate "
                         "against; its fingerprint joins the stored search "
                         "config, so calibrated and uncalibrated results "
                         "never mix on resume")
    ap.add_argument("--max-attempts", type=int, default=3,
                    help="attempts per cell before it is quarantined as a "
                         "status:failed record (transient failures retry "
                         "with deterministic seeded backoff; permanent "
                         "model errors never retry). Default: 3")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    metavar="S",
                    help="per-cell wall-clock deadline in seconds "
                         "(workers>1 only: a cell past its deadline is "
                         "charged a timeout attempt and the pool is "
                         "rebuilt). Default: none")
    ap.add_argument("--backoff", type=float, default=0.05, metavar="S",
                    help="base retry backoff in seconds (exponential per "
                         "attempt, deterministic per-cell jitter). "
                         "Default: 0.05")
    ap.add_argument("--retry-failed", action="store_true",
                    help="re-run cells quarantined by a previous run "
                         "(by default failed records resume as done so a "
                         "permanent failure is not re-hit every resume)")
    ap.add_argument("--weights", default="",
                    help="scalarization, e.g. throughput_ips=1,dsp_eff=500 "
                         "(fpga default: throughput only, the paper's "
                         "objective; tpu default: step_time_s)")
    ap.add_argument("--top", type=int, default=8, help="ranked rows to print")
    ap.add_argument("--frontier-json", default=None,
                    help="also dump the frontier records to this JSON file")
    ap.add_argument("--trace", action="store_true",
                    help="record campaign telemetry (repro.obs): per-cell "
                         "spans + pool gauges into <store>.events.jsonl "
                         "and a Chrome trace at <store>.trace.json; "
                         "inspect with python -m repro.dse.obs <store>")
    vq = ap.add_mutually_exclusive_group()
    vq.add_argument("-v", "--verbose", action="store_true",
                    help="per-cell convergence detail (stop reason, PSO "
                         "cache hits) on the progress lines")
    vq.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-cell progress lines (the final "
                         "report still prints)")
    args = ap.parse_args(argv)

    backend = get_backend(args.backend)
    weights = parse_weights(args.weights)
    workers = args.workers if args.workers > 0 else (os.cpu_count() or 1)
    cells = backend.cells_from_args(args)
    store_path = args.store or backend.default_store
    shard = int(args.shard) if str(args.shard).isdigit() else args.shard
    calibration = None
    if args.calibration:
        from repro_torch.calib import Calibration
        calibration = Calibration.load(args.calibration)
        print(f"calibration: {args.calibration} "
              f"({len(calibration.parts())} part(s), "
              f"fingerprint {calibration.fingerprint()})")
    policy = RetryPolicy(max_attempts=args.max_attempts,
                         backoff_s=args.backoff,
                         cell_timeout_s=args.cell_timeout,
                         seed=args.seed)
    report = run_campaign(cells, store_path,
                          base_seed=args.seed, population=args.population,
                          iterations=args.iterations, weights=weights,
                          workers=workers,
                          progress=None if args.quiet else print,
                          backend=backend, trace=args.trace,
                          verbose=args.verbose, searcher=args.searcher,
                          searcher_config=parse_searcher_config(
                              args.searcher_config), shard=shard,
                          **({"screen_device": args.device}
                             if args.device else {}),
                          calibration=calibration, policy=policy,
                          retry_failed=args.retry_failed)
    front = print_report(report, weights, args.top)

    if args.frontier_json:
        with open(args.frontier_json, "w") as f:
            json.dump(front, f, indent=2, sort_keys=True)
        print(f"\nfrontier -> {args.frontier_json}")
    print(f"store -> {store_path}")
    if report.events_path:
        print(f"events -> {report.events_path}")
        print(f"chrome trace -> {report.trace_path}")
    if report.partial:
        print_partial_summary(report, store_path)
    return report


def print_partial_summary(report: CampaignReport, store_path) -> None:
    """The honest-failure epilogue for a partial campaign: what was lost,
    why, and the exact resume move."""
    bits = []
    if report.interrupted:
        bits.append("interrupted by signal")
    if report.failed_cells:
        bits.append(f"{report.failed_cells} cell(s) quarantined")
    if report.missing_cells:
        bits.append(f"{report.missing_cells} cell(s) not run")
    print(f"\n!! partial campaign ({'; '.join(bits)}) — exit code 3")
    for rec in report.failures():
        print(f"   FAILED {rec['cell_key']}: {rec['error_type']} "
              f"after {rec['attempts']} attempt(s)")
    hint = f"python -m repro_torch.dse.campaign ... --store {store_path}"
    if report.failed_cells and not report.missing_cells \
            and not report.interrupted:
        hint += " --retry-failed"
    print(f"   resume: re-run the same command ({hint}); completed "
          f"cells are reused from the store")


def exit_code(report: CampaignReport) -> int:
    """0 for a full campaign, 3 for a partial one (interrupted,
    quarantined, or missing cells — resumable either way)."""
    return 3 if report.partial else 0


def run(argv: list[str] | None = None) -> int:
    """CLI entry point with exit-code semantics (``main`` returns the
    report for programmatic callers)."""
    return exit_code(main(argv))


if __name__ == "__main__":
    raise SystemExit(run())
