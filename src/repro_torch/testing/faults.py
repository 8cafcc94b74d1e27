"""Deterministic fault injection for campaign resilience tests.

A :class:`FaultPlan` maps cell keys to :class:`Fault` specs — what goes
wrong, and on which attempt numbers. The plan is JSON round-trippable so
spawn-based pool workers can load it from a file named by the
``REPRO_FAULTS`` env var (env vars are inherited across ``spawn``, open
objects are not). Five fault kinds cover the failure taxonomy the
resilience layer (:mod:`repro.dse.resilience`) must survive:

``raise-transient``
    Raise :class:`InjectedTransientError` (a ``RuntimeError``) — the
    retryable class: flaky I/O, OOM-adjacent allocation failures.
``raise-permanent``
    Raise :class:`InjectedPermanentError` (a ``ValueError``) — the
    deterministic-model-bug class that retrying cannot fix.
``hang-for``
    Sleep ``hang_s`` seconds before evaluating — exercises the per-cell
    wall-clock timeout (the parent kills and rebuilds the pool).
``crash-process``
    ``os._exit(17)`` — an un-catchable worker death (SIGKILL/OOM
    stand-in); the parent sees ``BrokenProcessPool`` and must rebuild.
``corrupt-record``
    Let the evaluation finish, then return a mangled record (no
    ``objectives``) — exercises the parent-side record validation.

The hook site is :func:`repro.dse.backends.run_cell_by_backend`, which
checks the env var with a single dict lookup and imports this module
only when a plan is armed — disabled, the hot path pays nothing.

Injection is deterministic two ways: explicitly (hand-written
``{cell_key: Fault}`` maps, the usual test style) or seeded
(:meth:`FaultPlan.seeded` hashes ``(seed, cell_key)`` to pick victims at
a given rate — same seed, same victims, independent of iteration order).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Mapping, Sequence

#: Env var naming a saved plan file; read (one dict lookup) per cell
#: evaluation, so arming a plan needs no plumbing through the pool.
ENV_VAR = "REPRO_FAULTS"

FAULT_KINDS = ("raise-transient", "raise-permanent", "hang-for",
               "crash-process", "corrupt-record")


class InjectedTransientError(RuntimeError):
    """An injected retryable failure (the resilience layer retries it)."""


class InjectedPermanentError(ValueError):
    """An injected permanent failure (quarantined without retry)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One cell's injected failure. ``attempts`` lists the attempt numbers
    (1-based) the fault fires on; empty means EVERY attempt — a fault
    that never goes away."""

    kind: str
    attempts: tuple[int, ...] = (1,)
    hang_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        object.__setattr__(self, "attempts",
                           tuple(int(a) for a in self.attempts))

    def fires_on(self, attempt: int) -> bool:
        return not self.attempts or attempt in self.attempts


@dataclasses.dataclass
class FaultPlan:
    """Cell key -> :class:`Fault`; the unit the harness loads and fires."""

    faults: dict[str, Fault] = dataclasses.field(default_factory=dict)

    @classmethod
    def seeded(cls, cell_keys: Sequence[str], *, seed: int = 0,
               rate: float = 0.25,
               kind: str = "raise-transient",
               attempts: Sequence[int] = (1,),
               hang_s: float = 0.0) -> "FaultPlan":
        """A deterministic plan: each cell key is a victim iff
        ``sha256(seed|key)`` maps below ``rate`` — stable across runs,
        orderings, and worker counts."""
        faults = {}
        for key in cell_keys:
            digest = hashlib.sha256(f"{seed}|{key}".encode()).digest()
            if int.from_bytes(digest[:8], "big") / 2 ** 64 < rate:
                faults[key] = Fault(kind, tuple(attempts), hang_s)
        return cls(faults)

    def fault_for(self, cell_key: str, attempt: int) -> Fault | None:
        f = self.faults.get(cell_key)
        return f if f is not None and f.fires_on(attempt) else None

    def fire_before(self, cell_key: str, attempt: int) -> None:
        """The pre-evaluation fault site: raise / hang / die. A no-op for
        cells without an armed fault (and for ``corrupt-record``, which
        fires after the evaluation)."""
        f = self.fault_for(cell_key, attempt)
        if f is None:
            return
        tag = f"injected[{f.kind}] {cell_key} (attempt {attempt})"
        if f.kind == "raise-transient":
            raise InjectedTransientError(tag)
        if f.kind == "raise-permanent":
            raise InjectedPermanentError(tag)
        if f.kind == "hang-for":
            time.sleep(f.hang_s)
        elif f.kind == "crash-process":
            # sys.stderr may be a worker pipe; nothing to say anyway —
            # the point is dying without cleanup, like SIGKILL/OOM
            os._exit(17)

    def mangle_after(self, cell_key: str, attempt: int, rec: dict) -> dict:
        """The post-evaluation fault site: ``corrupt-record`` returns the
        record without its ``objectives`` (what a half-pickled or
        truncated worker return looks like); everything else passes the
        record through untouched."""
        f = self.fault_for(cell_key, attempt)
        if f is None or f.kind != "corrupt-record":
            return rec
        bad = {k: v for k, v in rec.items() if k != "objectives"}
        bad["injected_corruption"] = True
        return bad

    # -- persistence (spawn workers re-load the plan from disk) -----------

    def as_dict(self) -> dict:
        return {"schema": 1,
                "faults": {k: dataclasses.asdict(f)
                           for k, f in sorted(self.faults.items())}}

    def save(self, path: str | os.PathLike) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.as_dict(), indent=2, sort_keys=True)
                     + "\n")
        return p

    @classmethod
    def from_dict(cls, d: Mapping) -> "FaultPlan":
        return cls({k: Fault(f["kind"], tuple(f.get("attempts", ())),
                             float(f.get("hang_s", 0.0)))
                    for k, f in d.get("faults", {}).items()})

    @classmethod
    def load(cls, path: str | os.PathLike) -> "FaultPlan":
        return cls.from_dict(json.loads(Path(path).read_text()))


def load_plan(src: "str | os.PathLike | Mapping | FaultPlan") -> FaultPlan:
    """Resolve any armed-plan reference — a :class:`FaultPlan`, a plan
    dict, or a path to a saved plan (what the env var carries)."""
    if isinstance(src, FaultPlan):
        return src
    if isinstance(src, Mapping):
        return FaultPlan.from_dict(src)
    return FaultPlan.load(src)
