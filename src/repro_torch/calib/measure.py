"""Measurement sources: predicted-vs-measured pairs the fit consumes.

A :class:`Measurement` is one (part, axis) comparison in TIME units:
what the analytic model predicted for a workload term vs what was
measured (or what a published number implies). Three sources feed
:func:`repro.calib.fit.fit_corrections`:

* :func:`hlo_dryrun_measurements` — ``repro.launch.dryrun`` artifacts:
  the exact-HLO compute term (``launch/hlo_cost.py`` loop-aware FLOPs at
  the part's peak) against the analytic roofline's compute term for the
  same (arch x shape x mesh) cell. This wires the dryrun's exact costs
  into the tpu/cuda evaluation loop *as ground truth for the model*.
* :func:`bench_measurements` — ``benchmarks/run.py --json`` rows: any
  row whose ``derived`` string carries ``calib_part/calib_axis/
  calib_pred_s/calib_meas_s`` fields contributes one measurement, so
  Pallas kernel microbenches become calibration evidence wherever real
  hardware runs the bench suite.
* :func:`repro.calib.published.published_measurements` — the committed
  MLPerf-style table for the GPU parts.

:func:`fixture_measurements` is the deterministic synthetic set (known
skews per part) used by tests, the CLI smoke, and the committed example
report.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Iterable, Mapping

from repro_torch.core.hw_specs import TPU_V5E, TPUSpec

from .calibration import Provenance

#: The two correction axes a spec exposes (see ``hw_specs.scaled_spec``).
AXES = ("compute", "bandwidth")

#: Fixed date stamped on fixture measurements so fixture-derived reports
#: are byte-stable for drift tests.
FIXTURE_DATE = "2026-08-01"


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One predicted-vs-measured time pair for a (part, axis).

    ``predicted_s``: the analytic model's time for the term;
    ``measured_s``: what the hardware (or the exact-HLO proxy, or a
    published delivered-rate) implies for the same term. The fitted
    scale divides predicted time — scale = predicted/measured — so a
    model that is optimistic (measured > predicted) fits a scale < 1."""

    part: str
    axis: str            # "compute" | "bandwidth"
    workload: str        # human label, e.g. "starcoder2-3b/train_4k"
    predicted_s: float
    measured_s: float
    provenance: Provenance

    def __post_init__(self):
        if self.axis not in AXES:
            raise ValueError(f"unknown axis {self.axis!r}; choose from {AXES}")
        if self.predicted_s <= 0 or self.measured_s <= 0:
            raise ValueError(f"measurement times must be positive "
                             f"(got predicted={self.predicted_s}, "
                             f"measured={self.measured_s})")


# ---------------------------------------------------------------------------
# source 1: exact-HLO dryrun artifacts (launch/hlo_cost.py)
# ---------------------------------------------------------------------------


def _artifact_mesh(name: str):
    from repro_torch.core.tpu_model import MeshDesc
    if name.startswith("single"):
        return MeshDesc.single_pod()
    if name.startswith("multi"):
        return MeshDesc.multi_pod()
    return None


def hlo_dryrun_measurements(dryrun_dir: str = "results/dryrun",
                            hw: TPUSpec = TPU_V5E) -> list[Measurement]:
    """Compute-axis measurements from ``repro.launch.dryrun`` artifacts.

    Per ``status: ok`` artifact: the analytic roofline's compute term for
    the cell vs the exact parsed-HLO FLOPs (loop-aware, fusion-descended
    — see :mod:`repro.launch.hlo_cost`) at the part's peak. The HLO
    memory term is NOT used: CPU-backend operand bytes are inflated by
    unfused materialization (see ``benchmarks/roofline.py``). Returns
    ``[]`` when the directory has no artifacts — calibration degrades
    gracefully on machines that never ran a dryrun."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.tpu_model import analytic_roofline, hlo_roofline
    out: list[Measurement] = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        try:
            with open(path) as f:
                cell = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if cell.get("status") != "ok" or "exact" not in cell:
            continue
        mesh = _artifact_mesh(str(cell.get("mesh", "")))
        if mesh is None:
            continue
        try:
            cfg = get_config(cell["arch"])
            shape = SHAPES[cell["shape"]]
        except KeyError:
            continue
        ana = analytic_roofline(cfg, shape, mesh, hw)
        hlo = hlo_roofline(cell["exact"], hw)
        if ana.t_compute <= 0 or hlo.t_compute <= 0:
            continue
        out.append(Measurement(
            part=hw.name, axis="compute",
            workload=f"{cell['arch']}/{cell['shape']}@{cell['mesh']}",
            predicted_s=ana.t_compute, measured_s=hlo.t_compute,
            provenance=Provenance(source=os.path.basename(path),
                                  date=str(cell.get("date", "")),
                                  kind="hlo_dryrun")))
    return out


# ---------------------------------------------------------------------------
# source 2: the repo's own microbenches (benchmarks/run.py --json)
# ---------------------------------------------------------------------------


def _derived_fields(derived: str) -> dict[str, str]:
    out = {}
    for tok in derived.split(";"):
        name, sep, val = tok.partition("=")
        if sep:
            out[name.strip()] = val.strip()
    return out


def bench_measurements(bench: Mapping,
                       date: str = "") -> list[Measurement]:
    """Measurements from a ``benchmarks/run.py --json`` dump.

    Any row whose ``derived`` string carries the four fields
    ``calib_part=<spec name>;calib_axis=compute|bandwidth;
    calib_pred_s=<s>;calib_meas_s=<s>`` contributes one measurement —
    the convention kernel microbenches use to publish ground truth when
    they run on real hardware. Rows without the fields are ignored, so
    the full bench dump can be fed in unfiltered."""
    out: list[Measurement] = []
    for bench_name, rows in sorted(bench.get("benchmarks", {}).items()):
        for row in rows:
            d = _derived_fields(str(row.get("derived", "")))
            if not {"calib_part", "calib_axis", "calib_pred_s",
                    "calib_meas_s"} <= d.keys():
                continue
            try:
                pred, meas = float(d["calib_pred_s"]), float(d["calib_meas_s"])
            except ValueError:
                continue
            if pred <= 0 or meas <= 0:
                continue
            out.append(Measurement(
                part=d["calib_part"], axis=d["calib_axis"],
                workload=str(row.get("name", bench_name)),
                predicted_s=pred, measured_s=meas,
                provenance=Provenance(
                    source=f"benchmarks/run.py:{row.get('name', bench_name)}",
                    date=date, kind="microbench")))
    return out


# ---------------------------------------------------------------------------
# fixture: deterministic synthetic measurements with known skew
# ---------------------------------------------------------------------------

#: (part, axis, workload, predicted_s, measured_s, kind). Skews are
#: deliberate: the model is optimistic on every part (measured > predicted)
#: with a small per-workload spread, so a fit improves — but cannot zero —
#: the error, exercising every column of the error table.
_FIXTURE_ROWS = (
    ("tpu_v5e", "compute", "starcoder2-3b/train_4k", 10.0, 12.4, "hlo_dryrun"),
    ("tpu_v5e", "compute", "xlstm-350m/train_4k", 1.00, 1.31, "hlo_dryrun"),
    ("tpu_v5e", "compute", "starcoder2-3b/decode_32k", 0.020, 0.024,
     "hlo_dryrun"),
    ("tpu_v5e", "bandwidth", "starcoder2-3b/train_4k", 4.00, 4.52,
     "microbench"),
    ("tpu_v5e", "bandwidth", "xlstm-350m/decode_32k", 0.0005, 0.00059,
     "microbench"),
    ("ku115", "compute", "vgg16@224x224", 0.0069, 0.0074, "microbench"),
    ("ku115", "compute", "vgg16@64x64", 0.00061, 0.00063, "microbench"),
    ("ku115", "bandwidth", "vgg16@32x32", 0.00020, 0.00023, "microbench"),
    ("a100-80g", "compute", "mlperf/train_large", 1.00, 1.92, "published"),
    ("a100-80g", "compute", "mlperf/train_small", 1.00, 1.79, "published"),
    ("a100-80g", "bandwidth", "stream/triad", 1.00, 1.18, "published"),
    ("h100", "compute", "mlperf/train_large", 1.00, 2.21, "published"),
    ("h100", "compute", "mlperf/train_small", 1.00, 2.02, "published"),
    ("h100", "bandwidth", "stream/triad", 1.00, 1.25, "published"),
)


def fixture_measurements() -> list[Measurement]:
    """The deterministic synthetic measurement set (known per-part skews,
    fixed provenance dates) behind tests, the CI smoke, and the committed
    ``docs/reports/example_calibration.md``."""
    return [Measurement(part=p, axis=a, workload=w, predicted_s=pred,
                        measured_s=meas,
                        provenance=Provenance(source=f"fixture:{w}",
                                              date=FIXTURE_DATE, kind=kind))
            for p, a, w, pred, meas, kind in _FIXTURE_ROWS]


def collect_measurements(*, dryrun_dir: str | None = None,
                         bench_json: str | None = None,
                         published: bool = False,
                         fixture: bool = False) -> list[Measurement]:
    """Gather measurements from every requested source (the CLI's input
    stage). Sources that yield nothing contribute nothing."""
    out: list[Measurement] = []
    if fixture:
        out += fixture_measurements()
    if dryrun_dir:
        out += hlo_dryrun_measurements(dryrun_dir)
    if bench_json:
        with open(bench_json) as f:
            out += bench_measurements(json.load(f))
    if published:
        from .published import published_measurements
        out += published_measurements()
    return out


def by_part_axis(measurements: Iterable[Measurement]
                 ) -> dict[tuple[str, str], list[Measurement]]:
    out: dict[tuple[str, str], list[Measurement]] = {}
    for m in measurements:
        out.setdefault((m.part, m.axis), []).append(m)
    return out
