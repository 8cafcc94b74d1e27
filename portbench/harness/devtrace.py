"""The device trace of a run's traced segment: ``torch.profiler`` (CUPTI)
around a few steps, its chrome traces written out, and their reduction to
what the per-layer readers and the result line need.

The segment is profiled twice, ``n`` steps each. First the device alone:
recording every host operation slows a host-paced step by a third and
more, which would read as idle device time, so the device times, the busy
time (the union of the intervals in which a kernel, a copy or a set ran)
and the window (the host's clock from an idle device to the end of the
last step's work) come from this pass. Then host and device together, only
to name the idle gaps: each gap by the innermost host operation running at
its middle on the thread that issued the work, or ``host`` where none was.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW_SPAN = "portbench.window"


def kernel_name(raw: str) -> str:
    """A device op's short name: no ``void``, namespace, template arguments or
    parameters (``void matmul_wgmma<Cfg<128>, bf16>(CUtensorMap, ...)`` ->
    ``matmul_wgmma``)."""
    name = raw.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    head = name.split("(")[0].partition("<")[0].strip()
    return head.split("::")[-1] or raw


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: dict          # short kernel name -> device seconds in the window
    idle_by_host: dict      # host op name -> idle seconds

    def device_total_s(self) -> float:
        return sum(self.device_s.values())

    def sum_of(self, names) -> float:
        return sum(self.device_s.get(n, 0.0) for n in names)

    def breakdown(self, top: int = 10) -> dict:
        def largest(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": largest(self.device_s), "idle_gaps": largest(self.idle_by_host)}


def record(step, n: int, out_dir: Path) -> Trace:
    """Profile ``n`` calls of ``step`` twice (device alone, then host and
    device), write both chrome traces into ``out_dir`` and reduce them."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device_path = out_dir / "device.json.gz"
    prof.export_chrome_trace(str(device_path))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    host_path = out_dir / "host.json.gz"
    prof.export_chrome_trace(str(host_path))
    trace = reduce_device(_load(device_path), window_s)
    trace.idle_by_host = idle_by_host(_load(host_path))
    return trace


def _load(path: Path) -> dict:
    with gzip.open(path, "rt") as f:
        return json.load(f)


def reduce_device(chrome: dict, window_s: float) -> Trace:
    """Device times and busy time of a trace of the device alone, over a
    window measured on the host (the device idle at its start)."""
    device, spans = {}, []
    for e in chrome.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        name = kernel_name(e["name"])
        device[name] = device.get(name, 0.0) + (b - a) * 1e-6
        spans.append((a, b))
    busy_s = sum(b - a for a, b in _merge(spans)) * 1e-6
    return Trace(window_s=window_s, busy_s=busy_s, device_s=device, idle_by_host={})


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host, points):
    """For each point (sorted), the name of the shortest host event covering
    it, or None. ``host``: (start, end, name) of one thread's events, which
    nest, so a sweep with a stack of the open events finds it."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    names, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def idle_by_host(chrome: dict) -> dict:
    """Idle seconds of a host-and-device trace's window (the benchmark's
    span), by the innermost host op running at each gap's middle."""
    evs = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in evs if e.get("name") == WINDOW_SPAN and e.get("cat") in HOST_CATS]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    busy = _merge([(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e.get("dur", 0))))
                   for e in evs if e.get("cat") in DEVICE_CATS])
    busy = [(a, b) for a, b in busy if b > a]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    tid = win[0].get("tid")
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]) for e in evs
            if e.get("cat") in HOST_CATS and e.get("tid") == tid and e["name"] != WINDOW_SPAN]
    idle: dict = {}
    for (a, b), name in zip(gaps, _innermost(host, [(a + b) / 2 for a, b in gaps])):
        idle[name or "host"] = idle.get(name or "host", 0.0) + (b - a) * 1e-6
    return idle
