"""Fit per-part corrections from measurements; compute error tables.

The fit is deliberately simple and provably safe: for each (part, axis)
the scale is the geometric mean of ``predicted_s / measured_s`` over
that group's measurements. Scaling the axis's delivered rate by that
factor divides every predicted time in the group by it, which minimizes
the RMS *log* error — so per part, the calibrated geometric-RMS error
can never exceed the raw error on the fitted set. That inequality is the
error table's contract (and a test).

Errors are reported as geometric-RMS relative error in percent:
``(exp(rms(ln(pred/meas))) - 1) * 100`` — symmetric in over/under
prediction, and 0% iff the model matches every measurement exactly.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

from .calibration import Calibration, Correction, Provenance
from .measure import Measurement, by_part_axis


def _geomean_ratio(ms: Sequence[Measurement]) -> float:
    """exp(mean ln(predicted/measured)) — the RMS-log-optimal scale."""
    return math.exp(sum(math.log(m.predicted_s / m.measured_s) for m in ms)
                    / len(ms))


def _rms_log_err_pct(ms: Sequence[Measurement], compute_scale: float,
                     bw_scale: float) -> float:
    """Geometric-RMS relative error (%) of the model over ``ms`` after
    scaling each axis's rate — i.e. dividing each predicted time by its
    axis's scale."""
    if not ms:
        return 0.0
    logs = []
    for m in ms:
        scale = compute_scale if m.axis == "compute" else bw_scale
        logs.append(math.log(m.predicted_s / scale / m.measured_s))
    rms = math.sqrt(sum(v * v for v in logs) / len(logs))
    return (math.exp(rms) - 1.0) * 100.0


def _merge_provenance(ms: Sequence[Measurement]) -> Provenance:
    """One provenance for a part's fit: sources joined (deduplicated,
    first-seen order), the latest date, kinds joined with ``+``."""
    sources, kinds, dates = [], [], []
    for m in ms:
        if m.provenance.source not in sources:
            sources.append(m.provenance.source)
        if m.provenance.kind not in kinds:
            kinds.append(m.provenance.kind)
        if m.provenance.date:
            dates.append(m.provenance.date)
    return Provenance(source="; ".join(sources),
                      date=max(dates) if dates else "",
                      kind="+".join(sorted(kinds)))


def fit_corrections(measurements: Iterable[Measurement]) -> Calibration:
    """Fit one :class:`Correction` per part appearing in ``measurements``.

    Per (part, axis): scale = geomean(predicted/measured). An axis with
    no measurements keeps scale 1.0 (and its count records 0, so the
    error table shows which axis the evidence actually covered)."""
    groups = by_part_axis(measurements)
    corrections: dict[str, Correction] = {}
    for part in sorted({p for p, _ in groups}):
        comp = groups.get((part, "compute"), [])
        bw = groups.get((part, "bandwidth"), [])
        compute_scale = _geomean_ratio(comp) if comp else 1.0
        bw_scale = _geomean_ratio(bw) if bw else 1.0
        part_ms = comp + bw
        corrections[part] = Correction(
            compute_scale=compute_scale, bw_scale=bw_scale,
            provenance=_merge_provenance(part_ms),
            n_compute=len(comp), n_bandwidth=len(bw),
            raw_err_pct=_rms_log_err_pct(part_ms, 1.0, 1.0),
            cal_err_pct=_rms_log_err_pct(part_ms, compute_scale, bw_scale))
    return Calibration(corrections)


def error_rows(calibration: Calibration) -> list[dict]:
    """The predicted-vs-measured error table, one dict per corrected
    part — rendered by ``repro.dse.report`` and the CLI. Self-contained:
    every column comes from the fit statistics the corrections carry, so
    a saved calibration file is enough to render the table."""
    rows = []
    for part in calibration.parts():
        c = calibration.correction(part)
        prov = c.provenance or Provenance("", "", "")
        rows.append({
            "part": part,
            "compute_scale": c.compute_scale, "bw_scale": c.bw_scale,
            "n": c.n_compute + c.n_bandwidth,
            "raw_err_pct": c.raw_err_pct, "cal_err_pct": c.cal_err_pct,
            "kind": prov.kind, "source": prov.source, "date": prov.date,
        })
    return rows


def validate_calibration(calibration: Calibration,
                         measurements: Iterable[Measurement] | None = None
                         ) -> list[str]:
    """Sanity-check a calibration; returns a list of problem strings
    (empty = valid). Checks the error-table contract (calibrated error
    <= raw error per part), provenance presence, scale sanity, and — when
    ``measurements`` are supplied — that recomputing the errors against
    them reproduces the stored fit statistics."""
    problems = []
    for part in calibration.parts():
        c = calibration.correction(part)
        if c.compute_scale <= 0 or c.bw_scale <= 0:
            problems.append(f"{part}: non-positive scale "
                            f"({c.compute_scale}, {c.bw_scale})")
        if not (0.05 <= c.compute_scale <= 20 and 0.05 <= c.bw_scale <= 20):
            problems.append(f"{part}: scale outside plausible 20x band "
                            f"({c.compute_scale:.4g}, {c.bw_scale:.4g})")
        if c.cal_err_pct > c.raw_err_pct + 1e-9:
            problems.append(f"{part}: calibrated error {c.cal_err_pct:.3f}% "
                            f"exceeds raw error {c.raw_err_pct:.3f}%")
        if c.provenance is None or not c.provenance.source:
            problems.append(f"{part}: correction has no provenance")
    if measurements is not None:
        groups = by_part_axis(measurements)
        for part in calibration.parts():
            c = calibration.correction(part)
            part_ms = groups.get((part, "compute"), []) + \
                groups.get((part, "bandwidth"), [])
            if not part_ms:
                problems.append(f"{part}: no measurements supplied for "
                                f"stored correction")
                continue
            raw = _rms_log_err_pct(part_ms, 1.0, 1.0)
            cal = _rms_log_err_pct(part_ms, c.compute_scale, c.bw_scale)
            if abs(raw - c.raw_err_pct) > 1e-6 or \
                    abs(cal - c.cal_err_pct) > 1e-6:
                problems.append(
                    f"{part}: stored errors (raw {c.raw_err_pct:.4f}%, cal "
                    f"{c.cal_err_pct:.4f}%) do not match the supplied "
                    f"measurements (raw {raw:.4f}%, cal {cal:.4f}%)")
    return problems
