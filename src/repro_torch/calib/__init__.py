"""Measurement-grounded calibration for the port's DSE: per-part
compute-rate and bandwidth multipliers with provenance
(:mod:`repro_torch.calib.calibration`, a copy of the JAX package's),
applied to ``hw_specs`` specs via
:func:`repro_torch.core.hw_specs.scaled_spec`, so that ``--calibration
JSON`` works in the port's campaign. The identity calibration leaves
records byte-identical.
"""
from .calibration import (Calibration, Correction, IDENTITY,  # noqa: F401
                          Provenance)

__all__ = ["Calibration", "Correction", "IDENTITY", "Provenance"]
