"""The port's DSE report, telemetry CLI and placement (``repro_torch.dse.
report``, ``.obs``, ``.placement``) against the JAX package's: the same
Markdown from the built-in fixture, from a calibrated fixture, from a
compare of two stores and from the port's own tpu and cuda campaign store;
``example_health_md()`` and the placement worked example equal to the
committed ``docs/reports/`` files byte for byte (rendered into a temporary
directory, never into ``docs/``); the same placements; and each CLI's
``--selftest`` exiting 0 without JAX."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.calib as ref_calib  # noqa: E402
from repro.core.hw_specs import CostEnvelope as RefEnvelope  # noqa: E402
from repro.dse import obs as ref_obs  # noqa: E402
from repro.dse import placement as ref_placement  # noqa: E402
from repro.dse import report as ref_report  # noqa: E402

import repro_torch.calib as port_calib  # noqa: E402
from repro_torch.core.hw_specs import CostEnvelope  # noqa: E402
from repro_torch.dse import backends, campaign, obs, placement, report  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REPORTS = ROOT / "docs" / "reports"
WORKLOADS = "starcoder2-3b/train_4k,xlstm-350m/decode_32k,vgg16@224x224"


def _run(module: str, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import runpy, sys\n"
            f"sys.argv = [{module!r}, *sys.argv[1:]]\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    code = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(code)\n")
    return subprocess.run([sys.executable, "-c", code, *map(str, args)], env=env,
                          capture_output=True, text=True, timeout=240, cwd=ROOT)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store the port's tpu and cuda campaigns wrote (two archs, two shapes,
    8 and 16 devices) under the fixture calibration."""
    path = tmp_path_factory.mktemp("store") / "mixed.jsonl"
    cal = port_calib.fit_corrections(port_calib.fixture_measurements())
    for be, kw in (("tpu", dict(chips=(8, 16))),
                   ("cuda", dict(gpus=(8, 16), gpu_types=("a100-80g", "h100")))):
        cells = backends.get_backend(be).expand_cells(
            archs=("starcoder2-3b", "xlstm-350m"), shapes=("train_4k", "decode_32k"), **kw)
        campaign.run_campaign(cells, str(path), backend=be, calibration=cal)
    return path


def test_fixture_records_and_events_are_the_references():
    assert report.fixture_records() == ref_report.fixture_records()
    assert report.fixture_events() == ref_report.fixture_events()


@pytest.mark.parametrize("kind", ["plain", "calibrated", "bench", "health"])
def test_render_report_from_the_fixture_is_the_references(kind):
    kw, rkw = {}, {}
    if kind == "calibrated":
        kw["calibration"] = port_calib.fit_corrections(port_calib.fixture_measurements())
        rkw["calibration"] = ref_calib.fit_corrections(ref_calib.fixture_measurements())
    elif kind == "bench":
        kw["bench"] = rkw["bench"] = {"benchmarks": {"h100_kernels": [
            {"name": "k", "us_per_call": 12.5, "derived": "calib_part=h100;calib_axis="
             "compute;calib_pred_s=1e-05;calib_meas_s=1.25e-05"}]}}
    elif kind == "health":
        kw["events"] = report.fixture_events()
        rkw["events"] = ref_report.fixture_events()
    md = report.render_report(report.fixture_records(), title=f"fixture {kind}", **kw)
    assert md == ref_report.render_report(ref_report.fixture_records(),
                                          title=f"fixture {kind}", **rkw)
    assert md.startswith(f"# fixture {kind}")


def test_render_compare_and_health_section_are_the_references():
    recs = report.fixture_records()
    half = [("a", recs[: len(recs) // 2]), ("b", recs)]
    assert report.render_compare(half, title="cmp") == ref_report.render_compare(half,
                                                                                 title="cmp")
    assert report.health_section(recs, report.fixture_events()) == \
        ref_report.health_section(recs, ref_report.fixture_events())


def test_report_of_the_ports_campaign_store_is_the_references(store, tmp_path):
    from repro_torch.dse.store import open_store
    recs = list(open_store(str(store)).iter_records())
    assert {r["backend"] for r in recs} == {"tpu", "cuda"} and len(recs) == 120
    cal = port_calib.fit_corrections(port_calib.fixture_measurements())
    rcal = ref_calib.fit_corrections(ref_calib.fixture_measurements())
    md = report.render_report(recs, title="mixed", calibration=cal)
    assert md == ref_report.render_report(recs, title="mixed", calibration=rcal)
    assert "## Calibration (predicted vs measured)" in md and cal.fingerprint() in md
    cal_path = tmp_path / "cal.json"
    cal.save(str(cal_path))
    r = _run("repro_torch.dse.report", store, "--calibration", cal_path, "--out",
             tmp_path / "port.md")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout
    assert ref_report.main([str(store), "--calibration", str(cal_path), "--out",
                            str(tmp_path / "ref.md")]) == 0
    assert (tmp_path / "port.md").read_text() == (tmp_path / "ref.md").read_text()


@pytest.mark.parametrize("module", ["repro_torch.dse.report", "repro_torch.dse.placement"])
def test_selftest_exits_zero_without_jax(module):
    r = _run(module, "--selftest")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "selftest OK" in r.stdout and "LOADED []" in r.stdout


def test_example_health_is_the_committed_report(tmp_path):
    assert obs.example_health_md() == ref_obs.example_health_md() == \
        (REPORTS / "example_health.md").read_text()
    r = _run("repro_torch.dse.obs", "--fixture", "--out", tmp_path / "health.md")
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "health.md").read_bytes() == (REPORTS / "example_health.md").read_bytes()


def test_placement_example_is_the_committed_report(tmp_path):
    out = tmp_path / "example_placement.md"
    r = _run("repro_torch.dse.placement", "--fixture", "--workloads", WORKLOADS,
             "--budget-usd", "60", "--budget-watts", "25000", "--solver", "exact",
             "--out", out)
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.read_bytes() == (REPORTS / "example_placement.md").read_bytes()


def _picked(result):
    return [(a.workload, dataclasses.asdict(a.candidate)) for a in result.assignments]


@pytest.mark.parametrize("solver", ["exact", "greedy"])
@pytest.mark.parametrize("usd,watts", [(60.0, 25000.0), (200.0, 80000.0)])
def test_placement_is_the_references(solver, usd, watts):
    workloads = placement.parse_workloads(WORKLOADS)
    assert workloads == ref_placement.parse_workloads(WORKLOADS)
    ours = placement.place(workloads, report.fixture_records(),
                           CostEnvelope(usd_per_hour=usd, watts=watts), solver=solver)
    theirs = ref_placement.place(workloads, ref_report.fixture_records(),
                                 RefEnvelope(usd_per_hour=usd, watts=watts), solver=solver)
    assert _picked(ours) == _picked(theirs)
    assert (ours.total_value, ours.total_usd, ours.total_watts) == \
        (theirs.total_value, theirs.total_usd, theirs.total_watts)
    assert report.render_placement(ours, title="p") == ref_report.render_placement(theirs,
                                                                                   title="p")


def test_placement_over_the_ports_store_is_the_references(store):
    from repro_torch.dse.store import open_store
    recs = placement.pooled_records([open_store(str(store))])
    workloads = ["starcoder2-3b/train_4k", "xlstm-350m/decode_32k"]
    env = dict(usd_per_hour=150.0, watts=40000.0)
    ours = placement.place(workloads, recs, CostEnvelope(**env), solver="exact")
    theirs = ref_placement.place(workloads, recs, RefEnvelope(**env), solver="exact")
    assert _picked(ours) == _picked(theirs)
    assert {a.candidate.backend for a in ours.assignments} <= {"tpu", "cuda"}
