"""The benchmark's readers of the program's own spans
(``portbench/harness/spans.py`` and the five metrics that use it) on a
hand-made run: the batcher's ring over the window's ticks, and each device
op of a hand-written host-and-device trace given to the innermost program
span around its launch."""
import gzip
import json
import types

import pytest

pytest.importorskip("torch")

from portbench.harness import devtrace, runner, spans, spec  # noqa: E402

SERVE = ["serve.host_ms_p50", "serve.sync_wait_ms_p50", "serve.generate_share"]
GLUE = ["decode.cache_write_share", "decode.cache_read_share"]


def _read(name, run):
    return spec.load_module("metrics", name).read(run)


def _tick_events(ticks):
    """A ring's events for ticks (tick, dur ms, sync ms, busy, generated)."""
    evs, sid = [], 0
    for tick, dur, sync, busy, gen in ticks:
        evs.append({"name": "serve.sync", "id": sid + 1, "parent": sid, "dur": sync * 1e-3,
                    "attrs": {}})
        evs.append({"name": "serve.tick", "id": sid, "parent": None, "dur": dur * 1e-3,
                    "attrs": {"tick": tick, "busy": busy, "generated": gen}})
        sid += 2
    return evs


def _run(events, first=3, last=5, **kw):
    ring = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        name="cell", seed=7, steps=[{"tick": t} for t in range(first, last + 1)],
        state={"batcher": types.SimpleNamespace(spans=ring)}, devtrace=None, traced_steps=[],
        **kw)


def test_serve_readers_take_the_windows_ticks():
    # ticks 1-2 are set-up and 6 the traced segment's: only 3-5 are read
    evs = _tick_events([(1, 500, 0, 1, 0), (2, 500, 0, 1, 0), (3, 70, 30, 64, 40),
                        (4, 75, 20, 64, 44), (5, 80, 35, 60, 40), (6, 1, 0, 1, 1)])
    run = _run(evs)
    assert _read("serve.host_ms_p50", run) == pytest.approx(45.0)   # 40, 55, 45
    assert _read("serve.sync_wait_ms_p50", run) == pytest.approx(30.0)
    assert _read("serve.generate_share", run) == pytest.approx(100 * 124 / 188)


def test_serve_readers_refuse_a_partial_window():
    evs = _tick_events([(4, 75, 20, 64, 44), (5, 80, 35, 60, 40)])
    for name in SERVE:
        with pytest.raises(RuntimeError, match="2 of the window's 3 ticks"):
            _read(name, _run(evs))


def test_serve_readers_are_silent_without_ticks_or_ring():
    prefill = _run([])
    prefill.steps = [{"t0": 0.0, "t1": 1.0}]
    older = _run([])
    older.state = {"batcher": types.SimpleNamespace()}  # a batcher that keeps no spans
    for name in SERVE:
        assert _read(name, prefill) is None and _read(name, older) is None


def _x(cat, name, ts, dur, tid=None, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if tid is not None:
        e["tid"] = tid
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """Host thread 1 runs the window, a tick, its decode and, inside it, the
    cache write, a wrapper call and the cache read; thread 2 launches one
    kernel outside any span. Device times in µs: write 30 + 10, read 20,
    matmul 5, decode glue 7, sync copy 3, thread 2's 4, one op without its
    launch 1: 80 in all."""
    return {"traceEvents": [
        _x("user_annotation", devtrace.WINDOW_SPAN, 0, 1000, tid=1),
        _x("user_annotation", "serve.tick", 10, 900, tid=1),
        _x("user_annotation", "serve.decode", 20, 600, tid=1),
        _x("user_annotation", "attn.cache_write", 30, 100, tid=1),
        _x("user_annotation", "kernels.matmul", 140, 20, tid=1),
        _x("user_annotation", "attn.cache_read", 200, 100, tid=1),
        _x("user_annotation", "serve.sync", 700, 100, tid=1),
        _x("cpu_op", "aten::mul", 35, 20, tid=1),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 5, tid=1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 5, tid=1, corr=2),
        _x("cuda_driver", "cuLaunchKernel", 150, 5, tid=1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 5, tid=1, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 400, 5, tid=1, corr=5),
        _x("cuda_runtime", "cudaMemcpyAsync", 710, 50, tid=1, corr=6),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 5, tid=2, corr=7),
        _x("kernel", "void elementwise_kernel<1>(int)", 100, 30, corr=1),
        _x("kernel", "void elementwise_kernel<2>(int)", 130, 10, corr=2),
        _x("kernel", "void matmul_wgmma<1>(int)", 160, 5, corr=3),
        _x("kernel", "void cunn_SoftMaxForwardReg<1>(int)", 230, 20, corr=4),
        _x("kernel", "void CatArrayBatchedCopy<1>(int)", 410, 7, corr=5),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 720, 3, corr=6),
        _x("kernel", "void other<1>(int)", 500, 4, corr=7),
        _x("kernel", "void orphan<1>(int)", 600, 1, corr=99),
        _x("gpu_user_annotation", "attn.cache_write", 100, 40),
        _x("gpu_user_annotation", "attn.cache_read", 230, 15),  # ends before its kernel
    ]}


def test_assignment_to_the_innermost_span():
    split = spans.assign(_trace())
    assert split.total_s == pytest.approx(80e-6)
    assert split.unlaunched_s == pytest.approx(1e-6)
    assert split.by_span == pytest.approx({
        "attn.cache_write": 40e-6, "kernels.matmul": 5e-6, "attn.cache_read": 20e-6,
        "serve.decode": 7e-6, "serve.sync": 3e-6, None: 4e-6})
    assert sum(split.by_span.values()) + split.unlaunched_s == pytest.approx(split.total_s)
    assert split.spans == {"serve.tick", "serve.decode", "attn.cache_write", "kernels.matmul",
                           "attn.cache_read", "serve.sync"}
    check = spans.annotated(_trace(), split)
    assert check["attn.cache_write"] == 1.0 and check["attn.cache_read"] == 0.0
    assert check["serve.decode"] == 0.0  # the trace has no range of that name


def _traced_run(tmp_path, chrome, monkeypatch, seed):
    d = tmp_path / f"cell.{seed}"
    d.mkdir(exist_ok=True)
    with gzip.open(d / "host.json.gz", "wt") as f:
        json.dump(chrome, f)
    monkeypatch.setattr(runner, "TRACE_DIR", tmp_path)
    run = _run([])
    run.seed = seed
    run.devtrace = types.SimpleNamespace(busy_s=1.0)
    run.traced_steps = [{"tick": 9}]
    return run


def test_glue_readers_share_the_traced_pass(tmp_path, monkeypatch):
    run = _traced_run(tmp_path, _trace(), monkeypatch, 1)
    assert _read("decode.cache_write_share", run) == pytest.approx(50.0)
    assert _read("decode.cache_read_share", run) == pytest.approx(25.0)


def test_glue_readers_are_silent_without_the_spans(tmp_path, monkeypatch):
    older = _trace()
    older["traceEvents"] = [e for e in older["traceEvents"]
                            if not e["name"].startswith("attn.")]
    run = _traced_run(tmp_path, older, monkeypatch, 2)
    prefill = _traced_run(tmp_path, _trace(), monkeypatch, 3)
    prefill.traced_steps = [{"t0": 0.0, "t1": 1.0}]
    untraced = _run([])
    for name in GLUE:
        assert _read(name, run) is None
        assert _read(name, prefill) is None and _read(name, untraced) is None


def test_glue_readers_read_a_retraced_seed_anew(tmp_path, monkeypatch):
    run = _traced_run(tmp_path, _trace(), monkeypatch, 4)
    assert _read("decode.cache_write_share", run) == pytest.approx(50.0)
    again = _trace()
    again["traceEvents"] = [e for e in again["traceEvents"]
                            if e.get("args", {}).get("correlation") != 2]
    run = _traced_run(tmp_path, again, monkeypatch, 4)
    assert _read("decode.cache_write_share", run) == pytest.approx(100.0 * 30 / 70)
