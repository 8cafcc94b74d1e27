"""The port's hot-path spans (repro_torch.obs.hotpath): the in-memory ring
in the trace schema, and the spans gated on torch.profiler, which cost no
``record_function`` while nothing records and name the device's idle gaps
while a profiler does."""
import json

import pytest

torch = pytest.importorskip("torch")

from portbench.harness import devtrace  # noqa: E402
from repro_torch.obs import chrome_trace, hotpath, load_events, validate_events  # noqa: E402


def _nested(ring, ticks):
    for t in range(ticks):
        with ring.span("serve.tick") as tick:
            with ring.span("serve.admit", rids=[t]):
                pass
            with ring.span("serve.decode"):
                with ring.span("inner"):
                    pass
            tick.attrs["tick"] = t + 1


def test_ring_keeps_the_last_maxlen_spans():
    ring = hotpath.SpanRing(7)
    _nested(ring, 5)
    evs = ring.events()
    assert len(evs) == 7
    # spans are kept as they end: the last 7 of 20 are tick 4's last three and tick 5's four
    assert [e["name"] for e in evs] == ["inner", "serve.decode", "serve.tick", "serve.admit",
                                        "inner", "serve.decode", "serve.tick"]
    # ids (and seq) count spans as they start: tick 4's are 12-15, tick 5's 16-19
    assert [e["id"] for e in evs] == [e["seq"] for e in evs] == [15, 14, 12, 17, 19, 18, 16]
    assert evs[-1]["attrs"] == {"tick": 5} and evs[3]["attrs"] == {"rids": [4]}


def test_events_are_trace_events(tmp_path):
    ring = hotpath.SpanRing(100, proc="batcher")
    _nested(ring, 3)
    evs = ring.events()
    assert validate_events(evs) == []
    chrome = chrome_trace(evs)
    assert sum(e["ph"] == "X" for e in chrome["traceEvents"]) == len(evs) == 12
    assert json.loads(json.dumps(chrome)) == chrome
    path = ring.dump(tmp_path / "b.events.jsonl")
    assert load_events(path) == json.loads(json.dumps(evs))


def test_every_parent_encloses_its_child():
    ring = hotpath.SpanRing(10)  # 10 of 12: the first tick's two oldest spans are gone
    _nested(ring, 3)
    evs = ring.events()
    by_id = {e["id"]: e for e in evs}
    assert sum(e["parent"] is None for e in evs) == 3
    for e in evs:
        if e["parent"] is None:
            assert e["depth"] == 0
            continue
        p = by_id[e["parent"]]
        assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-6
        assert e["depth"] == p["depth"] + 1


def test_no_record_function_while_nothing_records(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or hotpath._NULL_SPAN)
    assert not hotpath.recording()
    with hotpath.span("attn.cache_write"):
        pass
    _nested(hotpath.SpanRing(16), 2)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    rmsnorm(torch.ones(2, 8), torch.ones(8))
    assert entered == []


def test_gate_follows_the_profiler():
    """The flag the gate reads is the installed torch's: on under a profiler,
    off after it."""
    from torch.profiler import ProfilerActivity, profile
    assert not hotpath.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert hotpath.recording()
        assert hotpath.span("x") is not hotpath._NULL_SPAN
    assert not hotpath.recording()
    assert hotpath.span("x") is hotpath._NULL_SPAN


def test_spans_are_user_annotations_under_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.matmul.ops import matmul
    ring = hotpath.SpanRing(16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ring.span("serve.tick"):
            with hotpath.span("attn.cache_read"):
                matmul(torch.ones(4, 8), torch.ones(8, 2))
    path = tmp_path / "host.json"
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ann = {e["name"]: e for e in evs if e.get("cat") == "user_annotation"}
    assert {"serve.tick", "attn.cache_read", "kernels.matmul"} <= set(ann)
    outer, mid, inner = ann["serve.tick"], ann["attn.cache_read"], ann["kernels.matmul"]
    assert outer["ts"] <= mid["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= mid["ts"] + mid["dur"] <= outer["ts"] + outer["dur"]
    assert [e["name"] for e in ring.events()] == ["serve.tick"]


def test_idle_gap_takes_a_program_spans_name():
    """A gap of the device while the host is inside a program span and no
    aten op is named by that span (before: ``host``); one inside an op
    within the span by the op."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW_SPAN, "ts": 0, "dur": 100,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "serve.tick", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "serve.commit", "ts": 60, "dur": 40,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "kernels.matmul", "ts": 5, "dur": 20,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 12, "dur": 4, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "void k<1>(int)", "ts": 20, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "void k<2>(int)", "ts": 90, "dur": 10},
    ]
    # gaps [0, 20] (middle 10: the wrapper's checks), [60, 90] (middle 75: the commit loop)
    assert devtrace.idle_by_host({"traceEvents": ev}) == pytest.approx(
        {"kernels.matmul": 20e-6, "serve.commit": 30e-6})
    ev[4]["ts"] = 8  # an aten op at the first gap's middle names it
    assert devtrace.idle_by_host({"traceEvents": ev}) == pytest.approx(
        {"aten::empty": 20e-6, "serve.commit": 30e-6})
