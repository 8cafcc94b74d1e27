"""Committed table of published delivered-performance numbers.

The GPU parts in ``hw_specs`` carry datasheet peaks; published MLPerf
training results and STREAM-style bandwidth studies consistently show
large transformer workloads delivering roughly half of bf16 dense peak
and 80-90% of HBM peak. Each row below is the *delivered fraction* a
published result implies for one (part, axis); it becomes a
:class:`~repro.calib.measure.Measurement` with ``predicted_s = 1.0`` and
``measured_s = 1/fraction`` — the model (at datasheet peak) predicts
unit time, the published hardware needs ``1/fraction`` of it.

Numbers are round, conservative digests of public results — calibration
anchors, not leaderboard entries. Refitting against fresher rounds means
editing this table; provenance keeps each correction traceable to it.
"""
from __future__ import annotations

from .calibration import Provenance
from .measure import Measurement

#: (part, axis, workload, delivered_fraction, source, date).
PUBLISHED_TABLE = (
    ("a100-40g", "compute", "mlperf-train/bert", 0.50,
     "MLPerf Training v2.1 closed division digest", "2022-11-09"),
    ("a100-40g", "bandwidth", "stream/hbm2", 0.85,
     "STREAM-triad HBM2 measurements digest", "2021-06-01"),
    ("a100-80g", "compute", "mlperf-train/gpt3-175b", 0.52,
     "MLPerf Training v3.0 closed division digest", "2023-06-27"),
    ("a100-80g", "bandwidth", "stream/hbm2e", 0.85,
     "STREAM-triad HBM2e measurements digest", "2021-11-01"),
    ("h100", "compute", "mlperf-train/gpt3-175b", 0.46,
     "MLPerf Training v3.1 closed division digest", "2023-11-08"),
    ("h100", "bandwidth", "stream/hbm3", 0.80,
     "STREAM-triad HBM3 measurements digest", "2023-03-01"),
)


def published_measurements() -> list[Measurement]:
    """The committed table as measurements (``kind="published"``)."""
    return [Measurement(part=part, axis=axis, workload=workload,
                        predicted_s=1.0, measured_s=1.0 / frac,
                        provenance=Provenance(source=source, date=date,
                                              kind="published"))
            for part, axis, workload, frac, source, date in PUBLISHED_TABLE]
