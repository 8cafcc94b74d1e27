"""Spans on the port's hot path: the serving tick, decode attention and
the kernels' wrappers.

Two kinds, in the event schema of :mod:`repro_torch.obs.trace`, so one
set of readers (``validate_events``, ``load_events``, ``chrome_trace``,
``python -m repro_torch.dse.obs``) serves both:

* :func:`span` is **gated on** ``torch.profiler``. While a profiler
  records, it opens ``torch.profiler.record_function(name)``: the span is a
  ``user_annotation`` event on the profiler's host timeline, on the clock
  of CUPTI's device events, so a kernel's launch falls inside it and an
  idle gap of the device is named by it. Otherwise it returns one shared
  no-op object. The gate is what makes spans affordable on the hot path:
  ``record_function`` costs microseconds a call even with no profiler
  running, the gated no-op a fraction of one. Code called hundreds of
  times a tick (the kernels' wrappers) tests :func:`recording` inline and
  enters no ``with`` at all while nothing records.
* :class:`SpanRing` keeps host spans in memory, the last ``maxlen`` of
  them, each stamped with ``time.perf_counter`` and carrying its ``id``,
  the ``parent`` span that encloses it and its ``attrs``. Nothing is
  written while spans are recorded; :meth:`SpanRing.events` gives them as
  trace events (``ts`` wall-anchored as ``Tracer._wall`` anchors it) and
  :meth:`SpanRing.dump` writes them as JSONL. While a profiler records, a
  ring span also opens the gated ``record_function``.

A ``ContinuousBatcher`` keeps its ticks in ``batcher.spans``. To read them
with the store inspector, dump the ring as a store's events file::

    batcher.spans.dump("results/serve.events.jsonl")
    python -m repro_torch.dse.obs results/serve            # time by span
    python -m repro_torch.dse.obs results/serve --chrome   # Perfetto

Cost on an H100 80GB HBM3 host (StarCoder2-3B decode, 64 slots, a 71-74 ms
tick): with no profiler recording, the ring's six spans 5.5 us a tick, a
gated ``with`` 0.27-0.43 us, the wrappers' inline flag test 0.06-0.07 us a
call (31-44 us a tick in all; an ungated ``record_function`` costs 8.1 us
a call); while a profiler records, 10.8-11.6 us a range.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

from .trace import _NULL_SPAN, EVENTS_SCHEMA_VERSION

_now = time.perf_counter


def recording() -> bool:
    """True while a ``torch.profiler`` records (torch's own flag for fast checks)."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """``with span("attn.cache_write"): ...``: a ``record_function`` range
    while a profiler records, else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL_SPAN


class _RingSpan:
    """One live span of a :class:`SpanRing`; recorded on exit. ``attrs``
    may be filled inside the block (a tick's counts are known at its end)."""

    __slots__ = ("ring", "name", "attrs", "id", "parent", "t0", "range")

    def __init__(self, ring: "SpanRing", name: str, attrs: dict):
        self.ring, self.name, self.attrs = ring, name, attrs

    def __enter__(self):
        ring = self.ring
        self.id = sid = ring._next_id
        ring._next_id = sid + 1
        stack = ring._open
        self.parent = stack[-1] if stack else None
        stack.append(sid)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = self.ring._open
        stack.pop()
        self.ring._done.append((self.id, self.parent, len(stack), self.name, self.t0,
                                t1 - self.t0, self.attrs))
        return False


class SpanRing:
    """The last ``maxlen`` host spans of one owner, in memory.

    ``with ring.span("serve.tick", tick=3) as s: ...`` records the block's
    start and duration on ``time.perf_counter``, its id, the id of the
    ring span open around it (``parent``, None at the top) and its
    ``attrs``. A span is kept when it ends, so an enclosing span is always
    newer than the spans inside it: a span the ring still holds has its
    parent there too. Not thread-safe: one ring per thread of work."""

    def __init__(self, maxlen: int, proc: str = "main"):
        self.proc = proc
        self._done: deque = deque(maxlen=maxlen)
        self._open: list[int] = []
        self._next_id = 0
        self._t0_wall = time.time()
        self._t0_pc = _now()

    def span(self, name: str, **attrs) -> _RingSpan:
        return _RingSpan(self, name, attrs)

    def events(self) -> list[dict]:
        """The held spans as trace events, in the order they ended: the
        fields of ``repro_torch.obs.trace``'s spans plus ``id`` and
        ``parent``. A span's ``seq`` is its id (the order spans started)."""
        wall = self._t0_wall - self._t0_pc
        return [{"schema": EVENTS_SCHEMA_VERSION, "kind": "span", "name": name,
                 "proc": self.proc, "ts": round(wall + t0, 6), "seq": sid, "dur": dur,
                 "depth": depth, "id": sid, "parent": parent, "attrs": dict(attrs)}
                for sid, parent, depth, name, t0, dur, attrs in self._done]

    def dump(self, path: str | os.PathLike) -> Path:
        """Write :meth:`events` as JSONL (one sorted-key object a line, as
        ``Tracer`` writes); ``load_events`` reads it back."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            for ev in self.events():
                f.write(json.dumps(ev, sort_keys=True) + "\n")
        return path
