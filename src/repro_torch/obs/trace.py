"""Structured campaign telemetry: spans, counters, and gauges as JSONL.

The DSE engine's scaling claims (ROADMAP: "campaign engine at a million
cells") need to be *measured*, not guessed: where wall-clock goes (search
vs. pool overhead vs. store fsync), whether PSO searches converged or hit
the iteration cap, which workers sat idle. This module is the substrate —
a deliberately tiny tracer that costs nothing when disabled and writes
plain JSONL when enabled, so events diff, grep, and feed ``jq``/pandas
exactly like the result store does.

Design:

* :class:`Tracer` emits three event kinds — context-manager **spans**
  (``with tracer.span("cell.eval", cell=key): ...``), **counters**
  (monotonic totals, e.g. cache hits), and **gauges** (point-in-time
  values, e.g. pool occupancy) — one JSON object per line, appended and
  line-buffered so a killed run keeps everything emitted so far.
* **Disabled mode is near-zero overhead**: :data:`NULL` is a shared
  no-op tracer whose ``span`` returns one reusable no-op context
  manager; instrumented code never branches on "is tracing on".
* **Process safety via sidecar files**: each process (the campaign
  parent and every pool worker) owns a private
  ``<store>.events/<proc>.jsonl`` sidecar — no locks, no interleaved
  writes. The parent merges the sidecars deterministically
  (:func:`merge_events`: sorted by ``(ts, proc, seq)``, independent of
  directory listing order) into ``<store>.events.jsonl``.
* **Exporters**: the merged events JSONL is the source of truth;
  :func:`chrome_trace` re-expresses it in Chrome trace-event format
  (one lane per process) loadable in Perfetto / ``chrome://tracing``.
* **Schema-versioned**: every event carries ``schema`` =
  :data:`EVENTS_SCHEMA_VERSION`; :func:`validate_events` is the check CI
  runs against a freshly traced campaign.

Timestamps are wall-clock seconds anchored once per tracer
(``time.time()`` at construction + ``perf_counter`` deltas), so events
from different processes on one host line up on a shared axis.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from pathlib import Path
from typing import Iterable, Mapping, Sequence

#: Version stamp on every emitted event (bump on breaking format change).
EVENTS_SCHEMA_VERSION = 1

#: Event kinds :func:`validate_events` accepts.
EVENT_KINDS = ("span", "counter", "gauge")


# ---------------------------------------------------------------------------
# emitting
# ---------------------------------------------------------------------------


class _NullSpan:
    """Reusable no-op context manager (the disabled-mode ``span``)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled-mode tracer: every operation is a no-op, nothing touches
    the filesystem. Instrumented code holds one of these by default and
    never checks an enabled flag."""

    enabled = False
    path = None
    proc = "null"

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def span_at(self, name: str, ts: float, dur: float, **attrs) -> None:
        pass

    def count(self, name: str, n: float = 1, **attrs) -> None:
        pass

    def gauge(self, name: str, value: float, **attrs) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: The shared disabled tracer (analogue of ``logging.NullHandler``).
NULL = NullTracer()


class _Span:
    """Context manager for one live span; emits on exit."""

    __slots__ = ("tracer", "name", "attrs", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.depth = self.tracer._depth
        self.tracer._depth += 1
        return self

    def __exit__(self, *exc):
        self.tracer._depth -= 1
        dur = time.perf_counter() - self.t0
        self.tracer._emit("span", self.name, self.attrs,
                          ts=self.tracer._wall(self.t0), dur=dur,
                          depth=self.depth)
        return False


class Tracer:
    """Enabled tracer: appends one JSON line per event to ``path``.

    One tracer per process — spans nest via a per-tracer depth counter,
    and the per-tracer ``seq`` makes every event of one process totally
    ordered even when timestamps tie. Construction opens the file in
    append + line-buffered mode, so events survive a kill without an
    explicit flush and two tracers of the SAME process (rare, e.g. a
    resumed campaign) append rather than truncate.
    """

    enabled = True

    def __init__(self, path: str | os.PathLike, proc: str = "main"):
        self.path = Path(path)
        self.proc = proc
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("a", buffering=1)
        self._t0_wall = time.time()
        self._t0_pc = time.perf_counter()
        self._seq = 0
        self._depth = 0
        self.counters: dict[str, float] = {}

    # -- clock ---------------------------------------------------------------

    def _wall(self, pc: float | None = None) -> float:
        """perf_counter reading -> wall-clock seconds on the shared axis."""
        if pc is None:
            pc = time.perf_counter()
        return self._t0_wall + (pc - self._t0_pc)

    # -- event emission ------------------------------------------------------

    def _emit(self, kind: str, name: str, attrs: Mapping, *, ts: float,
              **fields) -> None:
        ev = {"schema": EVENTS_SCHEMA_VERSION, "kind": kind, "name": name,
              "proc": self.proc, "ts": round(ts, 6), "seq": self._seq}
        ev.update(fields)
        if attrs:
            ev["attrs"] = dict(attrs)
        self._seq += 1
        if not self._f.closed:
            self._f.write(json.dumps(ev, sort_keys=True) + "\n")

    def span(self, name: str, **attrs) -> _Span:
        """Time a block: ``with tracer.span("cell.eval", cell=key): ...``.
        The event is emitted at exit with the span's entry depth, so
        nested spans reconstruct as a tree."""
        return _Span(self, name, attrs)

    def span_at(self, name: str, ts: float, dur: float, **attrs) -> None:
        """Emit a span with an explicit start/duration — for intervals
        measured outside this process (e.g. queue wait: the parent's
        submit time to the worker's start)."""
        self._emit("span", name, attrs, ts=ts, dur=max(0.0, dur),
                   depth=self._depth)

    def count(self, name: str, n: float = 1, **attrs) -> None:
        """Add ``n`` to a monotonic counter and emit the increment.
        Totals accumulate on :attr:`counters` and at read time
        (:func:`counter_totals` sums increments across processes)."""
        self.counters[name] = self.counters.get(name, 0) + n
        self._emit("counter", name, attrs, ts=self._wall(), value=n)

    def gauge(self, name: str, value: float, **attrs) -> None:
        """Emit a point-in-time value (pool occupancy, cache-hit rate)."""
        self._emit("gauge", name, attrs, ts=self._wall(), value=value)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# store-adjacent paths + worker construction
# ---------------------------------------------------------------------------


def events_dir_for(store_path: str | os.PathLike) -> Path:
    """Per-process sidecar directory for a store: ``<store>.events/``."""
    return Path(str(store_path) + ".events")


def events_path_for(store_path: str | os.PathLike) -> Path:
    """The merged events JSONL for a store: ``<store>.events.jsonl``."""
    return Path(str(store_path) + ".events.jsonl")


def chrome_path_for(store_path: str | os.PathLike) -> Path:
    """The Chrome trace-event export for a store: ``<store>.trace.json``."""
    return Path(str(store_path) + ".trace.json")


def worker_tracer(events_dir: str | os.PathLike,
                  proc: str | None = None) -> Tracer:
    """A pool worker's tracer: its own ``<events_dir>/<proc>.jsonl``
    sidecar, named by pid by default (each spawn-pool worker is a
    distinct process; re-used workers append to their own file)."""
    proc = proc or f"worker-{os.getpid()}"
    return Tracer(Path(events_dir) / f"{proc}.jsonl", proc=proc)


# ---------------------------------------------------------------------------
# loading, merging, validation
# ---------------------------------------------------------------------------


def load_events(path: str | os.PathLike,
                stats: dict | None = None) -> list[dict]:
    """Events from one JSONL file (blank lines skipped; a torn final
    line — what an append-only writer leaves behind when its process is
    killed mid-write — is dropped, matching the result store's reader).
    Pass a ``stats`` dict to count what was skipped: its
    ``"skipped_lines"`` entry is incremented per undecodable line."""
    out = []
    p = Path(path)
    if not p.exists():
        return out
    with p.open() as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if stats is not None:
                    stats["skipped_lines"] = \
                        stats.get("skipped_lines", 0) + 1
                continue
    return out


def _merge_key(ev: Mapping) -> tuple:
    return (ev.get("ts", 0.0), str(ev.get("proc", "")), ev.get("seq", 0))


def merge_events(events_dir: str | os.PathLike,
                 out_path: str | os.PathLike | None = None) -> list[dict]:
    """Merge every ``*.jsonl`` sidecar under ``events_dir`` into one
    deterministic event list: sorted by ``(ts, proc, seq)`` — a total
    order (seq is unique per proc), so the merge is independent of
    directory listing order and stable across re-merges. Optionally
    writes the merged JSONL to ``out_path``.

    A sidecar truncated mid-write (worker killed, disk full) does not
    poison the merge: undecodable lines are skipped and surfaced as a
    single ``UserWarning`` with the count, so a crashed campaign's
    surviving telemetry still renders."""
    files = sorted(Path(events_dir).glob("*.jsonl"))
    stats: dict = {}
    events = [ev for f in files for ev in load_events(f, stats)]
    skipped = stats.get("skipped_lines", 0)
    if skipped:
        warnings.warn(f"merge_events: skipped {skipped} undecodable "
                      f"line(s) under {events_dir} (truncated sidecar?)",
                      stacklevel=2)
    events.sort(key=_merge_key)
    if out_path is not None:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("w") as f:
            for ev in events:
                f.write(json.dumps(ev, sort_keys=True) + "\n")
    return events


def validate_events(events: Iterable[Mapping]) -> list[str]:
    """Schema check for an event stream; returns problem strings
    (empty == valid). CI runs this against a freshly traced campaign."""
    problems = []
    for i, ev in enumerate(events):
        where = f"event {i}"
        if not isinstance(ev, Mapping):
            problems.append(f"{where}: not an object")
            continue
        if ev.get("schema") != EVENTS_SCHEMA_VERSION:
            problems.append(f"{where}: schema {ev.get('schema')!r} != "
                            f"{EVENTS_SCHEMA_VERSION}")
        kind = ev.get("kind")
        if kind not in EVENT_KINDS:
            problems.append(f"{where}: unknown kind {kind!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing/empty name")
        for field in ("ts",) + (("dur",) if kind == "span" else ("value",)):
            if not isinstance(ev.get(field), (int, float)) \
                    or isinstance(ev.get(field), bool):
                problems.append(f"{where}: {field} must be a number "
                                f"(got {ev.get(field)!r})")
        if kind == "span":
            if not isinstance(ev.get("depth"), int) or ev["depth"] < 0:
                problems.append(f"{where}: span depth must be an int >= 0")
            if isinstance(ev.get("dur"), (int, float)) \
                    and not isinstance(ev.get("dur"), bool) \
                    and ev["dur"] < 0:
                problems.append(f"{where}: span dur must be >= 0")
        if "attrs" in ev and not isinstance(ev["attrs"], Mapping):
            problems.append(f"{where}: attrs must be an object")
        if not isinstance(ev.get("proc"), str):
            problems.append(f"{where}: missing proc")
        if not isinstance(ev.get("seq"), int):
            problems.append(f"{where}: missing seq")
    return problems


# ---------------------------------------------------------------------------
# aggregation (shared by report.py's health section and the obs CLI)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0


def spans(events: Iterable[Mapping], name: str | None = None) -> list[dict]:
    """Span events, optionally filtered by name."""
    return [e for e in events if e.get("kind") == "span"
            and (name is None or e.get("name") == name)]


def span_totals(events: Iterable[Mapping]) -> dict[str, SpanStats]:
    """Per-span-name {count, total_s, max_s} — the wall-time breakdown."""
    out: dict[str, SpanStats] = {}
    for e in spans(events):
        st = out.setdefault(e["name"], SpanStats())
        st.count += 1
        st.total_s += e.get("dur", 0.0)
        st.max_s = max(st.max_s, e.get("dur", 0.0))
    return out


def counter_totals(events: Iterable[Mapping]) -> dict[str, float]:
    """Counter increments summed across all processes."""
    out: dict[str, float] = {}
    for e in events:
        if e.get("kind") == "counter":
            out[e["name"]] = out.get(e["name"], 0) + e.get("value", 0)
    return out


def campaign_wall(events: Sequence[Mapping]) -> float:
    """The campaign's wall time: the top-level ``campaign`` span if
    present, else the event-timestamp extent."""
    top = spans(events, "campaign")
    if top:
        return max(e.get("dur", 0.0) for e in top)
    ts = [e.get("ts", 0.0) for e in events]
    return (max(ts) - min(ts)) if len(ts) > 1 else 0.0


def worker_utilization(events: Sequence[Mapping],
                       busy_span: str = "cell.eval") -> dict[str, dict]:
    """Per-process busy accounting: ``{proc: {busy_s, cells, util}}``
    where ``util`` is busy time over the campaign wall time — the
    direct read on which workers sat idle."""
    wall = campaign_wall(events)
    out: dict[str, dict] = {}
    for e in spans(events, busy_span):
        row = out.setdefault(e.get("proc", "?"),
                             {"busy_s": 0.0, "cells": 0, "util": 0.0})
        row["busy_s"] += e.get("dur", 0.0)
        row["cells"] += 1
    for row in out.values():
        row["util"] = (row["busy_s"] / wall) if wall > 0 else 0.0
    return out


def slowest_spans(events: Iterable[Mapping], name: str = "cell.eval",
                  k: int = 10) -> list[dict]:
    """The ``k`` slowest spans of one name (slowest-cell table)."""
    return sorted(spans(events, name), key=lambda e: -e.get("dur", 0.0))[:k]


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------


def chrome_trace(events: Sequence[Mapping]) -> dict:
    """Events -> a Chrome trace-event JSON object (the ``traceEvents``
    array format), loadable in Perfetto / ``chrome://tracing``: one lane
    (tid) per process, spans as complete ``X`` events, counters and
    gauges as ``C`` counter samples. Timestamps are microseconds
    relative to the earliest event."""
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(e.get("ts", 0.0) for e in events)
    procs = sorted({str(e.get("proc", "?")) for e in events})
    tid = {p: i for i, p in enumerate(procs)}
    out = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid[p],
            "args": {"name": p}} for p in procs]
    counters: dict[str, float] = {}
    for e in events:
        lane = tid[str(e.get("proc", "?"))]
        us = (e.get("ts", 0.0) - t0) * 1e6
        if e.get("kind") == "span":
            out.append({"ph": "X", "name": e["name"], "pid": 0, "tid": lane,
                        "ts": round(us, 1),
                        "dur": round(e.get("dur", 0.0) * 1e6, 1),
                        "args": dict(e.get("attrs") or {})})
        elif e.get("kind") in ("counter", "gauge"):
            # counters plot running totals; gauges plot the sampled value
            v = e.get("value", 0)
            if e["kind"] == "counter":
                v = counters[e["name"]] = counters.get(e["name"], 0) + v
            out.append({"ph": "C", "name": e["name"], "pid": 0, "tid": lane,
                        "ts": round(us, 1), "args": {e["name"]: v}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}
