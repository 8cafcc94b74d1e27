"""The ``Calibration`` object: per-part correction factors + provenance.

A :class:`Correction` multiplies one hardware part's delivered compute
rate (``compute_scale``) and external-memory bandwidth (``bw_scale``) so
the analytic models predict what the part *measures*, not what its
datasheet promises. Each correction carries a :class:`Provenance` record
(where the measurements came from, when, and of what kind) plus the fit
statistics (measurement counts, raw vs calibrated error) so every
corrected campaign result is auditable back to its evidence.

A :class:`Calibration` maps part names (``hw_specs`` spec names:
``ku115``, ``tpu_v5e``, ``a100-80g``, ...) to corrections. Parts with no
entry get the identity correction; the empty calibration — the planners'
default — changes nothing, and :func:`Calibration.for_spec` returns the
spec object itself in that case, so uncalibrated evaluations are
byte-identical to pre-calibration behavior.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Mapping

from repro_torch.core.hw_specs import scaled_spec


@dataclasses.dataclass(frozen=True)
class Provenance:
    """Where a correction's measurements came from.

    ``kind`` is one of ``hlo_dryrun`` (exact-HLO costs from
    ``launch/hlo_cost.py`` artifacts), ``microbench`` (the repo's own
    benchmark rows), ``published`` (committed MLPerf-style numbers), or
    ``synthetic`` (test fixtures); merged fits join kinds with ``+``."""

    source: str
    date: str
    kind: str

    def as_dict(self) -> dict:
        return {"source": self.source, "date": self.date, "kind": self.kind}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Provenance":
        return cls(source=str(d.get("source", "")),
                   date=str(d.get("date", "")),
                   kind=str(d.get("kind", "")))


@dataclasses.dataclass(frozen=True)
class Correction:
    """One part's fitted multipliers + the evidence behind them.

    ``compute_scale`` / ``bw_scale`` multiply the spec's delivered
    compute rate / bandwidth (see
    :func:`repro.core.hw_specs.scaled_spec`); a scale below 1.0 means
    the hardware delivers less than the datasheet the model assumed.
    ``raw_err_pct`` / ``cal_err_pct`` are geometric-RMS relative errors
    of the model against the fitted measurements before and after the
    correction — the error-table columns."""

    compute_scale: float = 1.0
    bw_scale: float = 1.0
    provenance: Provenance | None = None
    n_compute: int = 0
    n_bandwidth: int = 0
    raw_err_pct: float = 0.0
    cal_err_pct: float = 0.0

    def is_identity(self) -> bool:
        return self.compute_scale == 1.0 and self.bw_scale == 1.0

    def as_dict(self) -> dict:
        return {
            "compute_scale": self.compute_scale, "bw_scale": self.bw_scale,
            "n_compute": self.n_compute, "n_bandwidth": self.n_bandwidth,
            "raw_err_pct": self.raw_err_pct, "cal_err_pct": self.cal_err_pct,
            "provenance": self.provenance.as_dict() if self.provenance
            else None,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "Correction":
        prov = d.get("provenance")
        return cls(compute_scale=float(d.get("compute_scale", 1.0)),
                   bw_scale=float(d.get("bw_scale", 1.0)),
                   provenance=Provenance.from_dict(prov) if prov else None,
                   n_compute=int(d.get("n_compute", 0)),
                   n_bandwidth=int(d.get("n_bandwidth", 0)),
                   raw_err_pct=float(d.get("raw_err_pct", 0.0)),
                   cal_err_pct=float(d.get("cal_err_pct", 0.0)))


_IDENTITY_CORRECTION = Correction()

#: On-disk schema version of ``Calibration.save`` files.
SCHEMA_VERSION = 1


class Calibration:
    """Part name -> :class:`Correction`; identity for unknown parts.

    Plain picklable container (campaign workers receive it through the
    process pool). JSON round-trips via :meth:`as_dict`/:meth:`from_dict`
    and :meth:`save`/:meth:`load`; :meth:`fingerprint` is the stable
    digest campaigns store in their resume-match search config."""

    def __init__(self, corrections: Mapping[str, Correction] | None = None):
        self._corrections: dict[str, Correction] = {
            k: v for k, v in (corrections or {}).items()
            if not v.is_identity()}

    def correction(self, part: str) -> Correction:
        return self._corrections.get(part, _IDENTITY_CORRECTION)

    def parts(self) -> tuple[str, ...]:
        return tuple(sorted(self._corrections))

    def is_identity(self) -> bool:
        return not self._corrections

    def __eq__(self, other) -> bool:
        return (isinstance(other, Calibration)
                and self._corrections == other._corrections)

    def __repr__(self) -> str:
        return f"Calibration({self._corrections!r})"

    def for_spec(self, spec):
        """``spec`` with this calibration's correction for ``spec.name``
        applied (via :func:`repro.core.hw_specs.scaled_spec`). Identity
        corrections return ``spec`` itself — the uncalibrated path is
        literally the existing code path."""
        c = self.correction(spec.name)
        return scaled_spec(spec, c.compute_scale, c.bw_scale)

    # -- serialization -------------------------------------------------------

    def as_dict(self) -> dict:
        return {"schema": SCHEMA_VERSION,
                "corrections": {k: v.as_dict()
                                for k, v in sorted(self._corrections.items())}}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Calibration":
        return cls({k: Correction.from_dict(v)
                    for k, v in d.get("corrections", {}).items()})

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.as_dict(), indent=1, sort_keys=True)
                        + "\n")
        return path

    @classmethod
    def load(cls, path: str | Path) -> "Calibration":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def fingerprint(self) -> str:
        """Stable short digest of the correction factors (provenance and
        fit stats excluded — two fits that land on the same multipliers
        resume each other's stores)."""
        scales = {k: [v.compute_scale, v.bw_scale]
                  for k, v in sorted(self._corrections.items())}
        blob = json.dumps(scales, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def record_info(self, part: str) -> dict | None:
        """The per-record calibration stamp campaign backends attach to
        store records evaluated under a non-identity correction: the
        factors actually applied plus their provenance, so corrected
        results stay auditable after a store resume. ``None`` when the
        part is uncorrected."""
        c = self.correction(part)
        if c.is_identity():
            return None
        return {"fingerprint": self.fingerprint(), "part": part,
                "compute_scale": c.compute_scale, "bw_scale": c.bw_scale,
                "provenance": c.provenance.as_dict() if c.provenance
                else None}


#: The planners' default: corrects nothing, fingerprints to the empty fit.
IDENTITY = Calibration()
