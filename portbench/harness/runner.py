"""One run of one cell: set-up, the measured window, the traced segment
(``--trace 1``), the check of ``correct``, and the result line.

Set-up is everything from the process's start to the window's start:
importing torch and the program, loading (the first run in a checkout:
building) the kernels, drawing the weights and inputs from the seed on the
device, and one pass of every shape the cell's traffic uses. The window
then runs whole cycles of the traffic's steps until ``--seconds`` have
passed. With ``--trace 1`` the same traffic continues after the window
under ``torch.profiler`` (``devtrace.record``: ``trace_steps`` steps twice);
the per-layer metrics read the window's spans and counters and that
segment's device trace. The
reference runs after both, once ``memory_peak_bytes`` has been read and the
program's state is freed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from . import devtrace, guard, judge, program, spec

TRACE_DIR = spec.ROOT / "build" / "portbench" / "traces"


def new_run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t0: float):
    run = types.SimpleNamespace(
        cell=cell, name=cell.name, config=cell.config, traffic=cell.traffic,
        arch=cell.config["arch"], seed=seed, seconds=seconds, trace=trace,
        device=torch.device(device), t0=t0, steps=[], traced_steps=[], devtrace=None,
        counters0={}, counters1={})
    run.gen = torch.Generator(device=run.device).manual_seed(seed)
    run.rng = np.random.default_rng(seed)
    return run


def setup(run) -> None:
    run.setup_parts = {"start_and_imports": time.time() - run.t0}
    run.ref = spec.reference(run.config)
    run.driver = spec.load_module("drivers", run.traffic["driver"])
    run.program_cfg = program.arch_config(run.config)
    run.weights = run.ref.make_weights(run.arch, run.config["init"], run.gen,
                                       dtype=getattr(torch, run.config["dtype"]))
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.setup_parts["weights"] = time.time() - run.t0 - sum(run.setup_parts.values())
    run.state = run.driver.setup(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.setup_parts["program_and_warmup"] = (time.time() - run.t0
                                             - sum(run.setup_parts.values()))
    guard.check("after set-up")
    run.setup_s = time.time() - run.t0


def window(run) -> None:
    d, state = run.driver, run.state
    run.counters0 = d.counters(state)
    start = time.perf_counter()
    while True:
        for _ in range(d.cycle(state)):
            run.steps.append(d.step(run, state))
        if run.steps[-1]["t1"] - start >= run.seconds:
            break
    run.window_s = run.steps[-1]["t1"] - start
    run.counters1 = d.counters(state)


def traced(run, out_dir: Path) -> None:
    n = run.traffic["trace_steps"]

    def step():
        run.traced_steps.append(run.driver.step(run, run.state))
    run.devtrace = devtrace.record(step, n, out_dir)
    del run.traced_steps[n:]  # the steps of the device-alone pass, which the readers use
    if run.devtrace.busy_s <= 0:
        raise RuntimeError("the profiler recorded no device activity in the traced window")
    (out_dir / "spans.json").write_text(json.dumps(
        {"window": run.steps, "traced": run.traced_steps, "setup_s": run.setup_s}))


def read_metrics(run, entries) -> dict:
    out = {}
    for m in entries:
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(run) -> dict:
    info = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
            "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
            else "cpu",
            "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    if run.devtrace is not None:
        info.update(busy_s=run.devtrace.busy_s, window_s=run.devtrace.window_s)
    return info


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t0: float | None = None, control: bool = False) -> tuple[dict, dict]:
    """One run; returns (the result line, the readings of the comparison).
    With ``control``, the readings also hold the control's (``control``),
    judged by the same comparison in the program's place."""
    run = new_run(cell, seed, seconds, trace, device, time.time() if t0 is None else t0)
    setup(run)
    window(run)
    if trace:
        traced(run, TRACE_DIR / f"{cell.name}.{seed}")
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(run.device)
                             if run.device.type == "cuda" else 0)
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    judged = run.driver.judged(run, run.state)
    attempted = run.driver.attempted(run, run.state)
    run.driver.close(run.state)
    del run.state
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    read = judge.readings(judged, run.ref, run.weights, run.config)
    read["setup"] = run.setup_parts
    cmp = judge.compared(read, cell.judge["limits"])
    if control:
        low = judge.readings(judge.control_judged(judged, run.ref, run.weights, run.config),
                             run.ref, run.weights, run.config)
        low_cmp = judge.compared(low, cell.judge["limits"])
        read["control"] = dict(low, compared=low_cmp, correct=judge.correct(low_cmp, low))
    result = {"correct": judge.correct(cmp, read), "attempted": attempted,
              "failed": read["failed"], "metrics": metrics, "device": device_info(run)}
    if trace:
        result["breakdown"] = run.devtrace.breakdown()
    result["compared"] = cmp
    return result, read


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py",
                                 description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    result, read = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    print("portbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in read["setup"].items()),
          file=sys.stderr)
    print(f"portbench: {cell.name} seed {args.seed}: judged {read['sequences']} sequences, "
          f"{read['positions']} positions, widest gap {read['gap']!r}, reference "
          f"{read['reference_s']:.1f} s", file=sys.stderr)
    guard.check("before the result")
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
