"""Measurement-grounded calibration for the port's DSE: close the
predicted-vs-measured loop. The modules are copies of the JAX package's
``repro.calib``:

* :mod:`repro_torch.calib.calibration` — ``Provenance`` / ``Correction`` /
  ``Calibration``: per-part compute-rate and bandwidth multipliers with
  provenance, applied to ``hw_specs`` specs via
  :func:`repro_torch.core.hw_specs.scaled_spec`. The identity calibration
  leaves records byte-identical.
* :mod:`repro_torch.calib.measure` — the measurement sources feeding one
  fit: the dry run's counted costs (``repro_torch.launch.dryrun``
  artifacts), kernel rows in the ``benchmarks/run.py --json`` shape (which
  ``chip_smoke.py`` writes from the H100's own kernel timings), and the
  committed published table (:mod:`repro_torch.calib.published`).
* :mod:`repro_torch.calib.fit` — geometric-mean fitting and the
  predicted-vs-measured error table.

CLI: ``python -m repro_torch.calib fit|show|validate|example``.
"""
from .calibration import (Calibration, Correction, IDENTITY,  # noqa: F401
                          Provenance)
from .fit import error_rows, fit_corrections, validate_calibration
from .measure import (Measurement, bench_measurements, fixture_measurements,
                      hlo_dryrun_measurements)
from .published import published_measurements

__all__ = [
    "Calibration", "Correction", "IDENTITY", "Measurement", "Provenance",
    "bench_measurements", "error_rows", "fit_corrections",
    "fixture_measurements", "hlo_dryrun_measurements",
    "published_measurements", "validate_calibration",
]
