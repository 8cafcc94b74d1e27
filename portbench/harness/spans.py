"""The program's own spans, as the per-layer readers read them.

Two sources. The serving batcher keeps every tick in memory
(``ContinuousBatcher.spans``, a ``repro_torch.obs.hotpath.SpanRing``):
``window_ticks`` takes the window's ``serve.tick`` spans out of it, on the
untraced window's own clock. While ``torch.profiler`` records, the
program's spans are ``user_annotation`` events of the host-and-device
trace (``devtrace.record``'s second pass): ``assign`` gives each
device op (kernel, copy, set) to the innermost program span around its
launch, found by the op's ``correlation`` to its ``cuda_runtime`` /
``cuda_driver`` launch event and from that event's host time to the spans
on the launching thread.

A program without these spans (an older checkout) gives None, never an
error; a ring that no longer holds the window's first tick raises.

    python -m portbench.harness.spans build/portbench/traces/<cell>.<seed>

prints a traced run's split by span, and how much of each span's device
time lies inside the trace's ``gpu_user_annotation`` range of that name.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import gzip
import json
import sys
from pathlib import Path

from . import devtrace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PROGRAM_CAT = "user_annotation"


def window_ticks(run) -> list | None:
    """The window's ticks as (``serve.tick`` event, its ``serve.sync``
    seconds), in tick order, from the batcher's ring; None where the run
    serves no ticks or its batcher keeps no ring."""
    if not run.steps or "tick" not in run.steps[0]:
        return None
    ring = getattr(run.state.get("batcher"), "spans", None)
    if ring is None:
        return None
    first, last = run.steps[0]["tick"], run.steps[-1]["tick"]
    events = ring.events()
    ticks = {e["attrs"]["tick"]: e for e in events
             if e["name"] == "serve.tick" and first <= e["attrs"].get("tick", 0) <= last}
    if len(ticks) != last - first + 1:
        raise RuntimeError(f"the batcher's ring holds {len(ticks)} of the window's "
                           f"{last - first + 1} ticks: it keeps too few spans for the window")
    sync = {e["parent"]: e["dur"] for e in events if e["name"] == "serve.sync"}
    return [(ticks[t], sync[ticks[t]["id"]]) for t in range(first, last + 1)]


@dataclasses.dataclass
class DeviceSplit:
    by_span: dict       # innermost program span around the launch (None: none) -> seconds
    unlaunched_s: float  # device seconds whose launch the trace does not hold
    total_s: float      # every device op of the trace
    spans: frozenset    # names of the program spans the trace holds
    ops: list           # (device event, its span name or None) of each launched op


def assign(chrome: dict) -> DeviceSplit:
    """Each device op of a host-and-device chrome trace to the innermost
    program span (a ``user_annotation`` other than the benchmark's window)
    open on the launching thread when its launch started."""
    evs = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    launches = {e["args"]["correlation"]: e for e in evs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    spans: dict = {}
    for e in evs:
        if e.get("cat") == PROGRAM_CAT and e["name"] != devtrace.WINDOW_SPAN:
            t = float(e["ts"])
            spans.setdefault(e.get("tid"), []).append((t, t + float(e.get("dur", 0)), e["name"]))
    points: dict = {}
    unlaunched = total = 0.0
    for e in evs:
        if e.get("cat") not in devtrace.DEVICE_CATS:
            continue
        s = float(e.get("dur", 0)) * 1e-6
        total += s
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            unlaunched += s
            continue
        points.setdefault(launch.get("tid"), []).append((float(launch["ts"]), s, e))
    by_span: dict = {}
    ops = []
    for tid, pts in points.items():
        pts.sort(key=lambda p: p[0])
        for (_, s, e), name in zip(pts, devtrace._innermost(spans.get(tid, []),
                                                            [p[0] for p in pts])):
            by_span[name] = by_span.get(name, 0.0) + s
            ops.append((e, name))
    names = frozenset(n for host in spans.values() for _, _, n in host)
    return DeviceSplit(by_span, unlaunched, total, names, ops)


@functools.lru_cache(maxsize=1)
def _split_of(path: str, mtime_ns: int, size: int) -> DeviceSplit:
    """The split of one trace file, kept while the file is unchanged
    (``mtime_ns`` and ``size`` are part of the key: a cell traced again
    under the same seed rewrites the file)."""
    with gzip.open(path, "rt") as f:
        return assign(json.load(f))


def span_share(run, trace_dir: Path, name: str) -> float | None:
    """Percent of the device time of ``trace_dir``'s host-and-device pass
    launched inside the span ``name``; None for a run that traced no
    ticks, or a trace that holds no such span."""
    if run.devtrace is None or not run.traced_steps or "tick" not in run.traced_steps[0]:
        return None
    path = trace_dir / "host.json.gz"
    st = path.stat()
    split = _split_of(str(path), st.st_mtime_ns, st.st_size)
    if name not in split.spans or split.total_s <= 0:
        return None
    return 100.0 * split.by_span.get(name, 0.0) / split.total_s


def annotated(chrome: dict, split: DeviceSplit) -> dict:
    """Per span name, the share of its assigned device time that lies
    inside a ``gpu_user_annotation`` range of the same name: the profiler's
    own view of the same assignment, as a check of it."""
    ranges: dict = {}
    for e in chrome.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation":
            t = float(e["ts"])
            ranges.setdefault(e["name"], []).append((t, t + float(e.get("dur", 0))))
    merged = {n: devtrace._merge(r) for n, r in ranges.items()}
    starts = {n: [a for a, _ in r] for n, r in merged.items()}
    inside: dict = {}
    for e, name in split.ops:
        if name is None:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        i = bisect.bisect_right(starts.get(name, []), a) - 1
        ok = i >= 0 and merged[name][i][1] >= b - 1e-2  # ts and dur are rounded apart
        got = inside.setdefault(name, [0.0, 0.0])
        got[0] += (b - a) * ok
        got[1] += b - a
    return {n: (v[0] / v[1] if v[1] > 0 else 1.0) for n, v in inside.items()}


def main(argv) -> int:
    path = Path(argv[0]) / "host.json.gz"
    with gzip.open(path, "rt") as f:
        chrome = json.load(f)
    split = assign(chrome)
    check = annotated(chrome, split)
    print(f"device ops {split.total_s * 1e3:.3f} ms; launch not found "
          f"{split.unlaunched_s * 1e3:.3f} ms")
    for name, s in sorted(split.by_span.items(), key=lambda kv: -kv[1]):
        print(f"{str(name):<26} {s * 1e3:10.3f} ms {100 * s / split.total_s:7.2f} %"
              + (f"   inside its gpu_user_annotation {100 * check[name]:.2f} %"
                 if name in check else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
