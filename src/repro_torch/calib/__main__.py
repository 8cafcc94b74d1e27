"""CLI for the calibration loop: fit, show, validate, example.

* ``fit``      — gather measurements (fixture / dryrun artifacts / bench
  json / published table), fit per-part corrections, save to ``--out``.
* ``show``     — print a saved calibration's error table.
* ``validate`` — check a saved calibration (error-table contract,
  provenance, scale sanity); exit 1 with the problems listed if invalid.
* ``example``  — regenerate the committed, drift-tested
  ``docs/reports/example_calibration.md`` from the fixture measurements.

Examples::

    python -m repro.calib fit --fixture --out calib.json
    python -m repro.calib fit --dryrun-dir results/dryrun --published \\
        --out calib.json
    python -m repro.calib show calib.json
    python -m repro.calib validate calib.json --fixture
    python -m repro.calib example --out docs/reports/example_calibration.md
"""
from __future__ import annotations

import argparse
import sys

from .calibration import Calibration
from .fit import error_rows, fit_corrections, validate_calibration
from .measure import FIXTURE_DATE, collect_measurements, fixture_measurements


def error_table_markdown(calibration: Calibration) -> str:
    """The predicted-vs-measured error table as a GitHub-markdown table
    (also embedded by ``repro.dse.report``). One row per corrected part:
    fitted scales, measurement count, raw vs calibrated geometric-RMS
    error, and provenance."""
    headers = ("part", "compute x", "bandwidth x", "n", "raw err %",
               "cal err %", "kind", "source (date)")
    lines = ["| " + " | ".join(headers) + " |",
             "| " + " | ".join("---" for _ in headers) + " |"]
    for r in error_rows(calibration):
        src = r["source"].replace("|", "\\|")
        if r["date"]:
            src += f" ({r['date']})"
        lines.append("| " + " | ".join((
            r["part"], f"{r['compute_scale']:.4f}", f"{r['bw_scale']:.4f}",
            str(r["n"]), f"{r['raw_err_pct']:.2f}", f"{r['cal_err_pct']:.2f}",
            r["kind"], src)) + " |")
    if len(lines) == 2:
        lines.append("| (identity calibration — no corrections) | " +
                     " | ".join("" for _ in headers[1:]) + " |")
    return "\n".join(lines)


def _add_source_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fixture", action="store_true",
                   help="include the deterministic synthetic fixture set")
    p.add_argument("--dryrun-dir", default=None, metavar="DIR",
                   help="include exact-HLO dryrun artifacts from DIR")
    p.add_argument("--bench", default=None, metavar="JSON",
                   help="include calib_* rows from a benchmarks/run.py "
                        "--json dump")
    p.add_argument("--published", action="store_true",
                   help="include the committed published-numbers table")


def _gather(args) -> list:
    ms = collect_measurements(dryrun_dir=args.dryrun_dir,
                              bench_json=args.bench,
                              published=args.published, fixture=args.fixture)
    if not ms:
        sys.exit("no measurements: pass --fixture, --dryrun-dir, --bench "
                 "and/or --published (or the chosen sources were empty)")
    return ms


def example_markdown() -> str:
    """The byte-stable example report: fixture measurements -> fit ->
    error table. Committed as ``docs/reports/example_calibration.md`` and
    drift-tested, so doc readers see exactly what the code produces."""
    cal = fit_corrections(fixture_measurements())
    return "\n".join([
        "# Example calibration report",
        "",
        "Generated by `python -m repro.calib example` from the fixture",
        "measurement set (`repro.calib.measure.fixture_measurements`,",
        f"dated {FIXTURE_DATE}) — synthetic predicted-vs-measured pairs",
        "with known per-part skew. Regenerate after changing the fixture",
        "or the fit; CI diffs this file against fresh output.",
        "",
        "## Predicted vs measured error table",
        "",
        error_table_markdown(cal),
        "",
        f"Calibration fingerprint: `{cal.fingerprint()}`",
        "",
        "Reading the table: `compute x` / `bandwidth x` multiply the",
        "part's delivered rate (below 1.0 = hardware delivers less than",
        "the datasheet peak the model assumed); `raw err %` is the",
        "geometric-RMS error of the uncalibrated model against the",
        "measurements, `cal err %` after applying the fitted scales —",
        "the fit guarantees `cal <= raw` on every row.",
        ""])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calib",
        description="fit / inspect / validate measurement-grounded "
                    "calibrations for the analytic models")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_fit = sub.add_parser("fit", help="fit corrections from measurements")
    _add_source_flags(p_fit)
    p_fit.add_argument("--out", default="calib.json",
                       help="path to save the fitted calibration")

    p_show = sub.add_parser("show", help="print a calibration's error table")
    p_show.add_argument("calibration", help="path to a saved calibration")

    p_val = sub.add_parser("validate",
                           help="check a saved calibration; exit 1 on "
                                "problems")
    p_val.add_argument("calibration", help="path to a saved calibration")
    _add_source_flags(p_val)

    p_ex = sub.add_parser("example",
                          help="regenerate the committed example report")
    p_ex.add_argument("--out", default="docs/reports/example_calibration.md")

    args = ap.parse_args(argv)

    if args.cmd == "fit":
        ms = _gather(args)
        cal = fit_corrections(ms)
        path = cal.save(args.out)
        print(f"fitted {len(cal.parts())} part(s) from {len(ms)} "
              f"measurement(s) -> {path} (fingerprint {cal.fingerprint()})")
        print(error_table_markdown(cal))
        return 0

    if args.cmd == "show":
        cal = Calibration.load(args.calibration)
        print(f"calibration {args.calibration} "
              f"(fingerprint {cal.fingerprint()})")
        print(error_table_markdown(cal))
        return 0

    if args.cmd == "validate":
        cal = Calibration.load(args.calibration)
        ms = None
        if args.fixture or args.dryrun_dir or args.bench or args.published:
            ms = collect_measurements(dryrun_dir=args.dryrun_dir,
                                      bench_json=args.bench,
                                      published=args.published,
                                      fixture=args.fixture)
        problems = validate_calibration(cal, ms)
        if problems:
            for p in problems:
                print(f"INVALID: {p}")
            return 1
        extra = f" against {len(ms)} measurement(s)" if ms is not None else ""
        print(f"ok: {len(cal.parts())} correction(s) valid{extra} "
              f"(fingerprint {cal.fingerprint()})")
        return 0

    if args.cmd == "example":
        md = example_markdown()
        from pathlib import Path
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(md)
        print(f"wrote {out} ({len(md)} bytes)")
        return 0

    raise AssertionError(f"unhandled command {args.cmd!r}")


if __name__ == "__main__":
    sys.exit(main())
