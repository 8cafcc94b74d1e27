"""The port's calibration loop (``repro_torch.calib``) against the JAX
package's: the same fits, error tables and validations from each
measurement source; the CLI's ``fit``, ``show`` and ``validate`` give the
reference's fingerprint and file; ``example`` writes the committed
``docs/reports/example_calibration.md`` byte for byte; ``bench_measurements``
reads the card's kernel rows, built by ``chip_smoke.calib_row``, as the
reference does; and ``hlo_dryrun_measurements`` reads the port's dry-run
artifacts as the reference reads them."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.calib as ref  # noqa: E402
from repro.calib.__main__ import example_markdown as ref_example  # noqa: E402
from repro.calib.__main__ import main as ref_main  # noqa: E402
from repro.calib.measure import collect_measurements as ref_collect  # noqa: E402

import repro_torch.calib as port  # noqa: E402
from repro_torch.calib.__main__ import example_markdown  # noqa: E402
from repro_torch.calib.measure import collect_measurements  # noqa: E402
from repro_torch.core.hw_specs import H100  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "docs" / "reports" / "example_calibration.md"
SOURCES = {"fixture": dict(fixture=True), "published": dict(published=True),
           "fixture+published": dict(fixture=True, published=True)}


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py as a module: importing it runs nothing and needs no card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(measurements) -> list:
    return [dataclasses.asdict(m) for m in measurements]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.calib", *map(str, args)],
                          env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_fit_is_the_references(source):
    ours, theirs = collect_measurements(**SOURCES[source]), ref_collect(**SOURCES[source])
    assert _ms(ours) == _ms(theirs)
    cal, rcal = port.fit_corrections(ours), ref.fit_corrections(theirs)
    assert cal.as_dict() == rcal.as_dict() and cal.fingerprint() == rcal.fingerprint()
    assert port.error_rows(cal) == ref.error_rows(rcal)
    assert port.validate_calibration(cal, ours) == ref.validate_calibration(rcal, theirs) == []


def test_published_digest_is_the_references():
    assert _ms(port.published_measurements()) == _ms(ref.published_measurements())
    h100 = port.fit_corrections(port.published_measurements()).correction("h100")
    assert (round(h100.compute_scale, 12), round(h100.bw_scale, 12)) == (0.46, 0.8)


def test_cli_fit_show_validate_give_the_references_fingerprint(tmp_path):
    theirs = tmp_path / "ref.json"
    assert ref_main(["fit", "--fixture", "--published", "--out", str(theirs)]) == 0
    fp = ref.Calibration.load(theirs).fingerprint()
    ours = tmp_path / "port.json"
    fit = _cli("fit", "--fixture", "--published", "--out", ours)
    assert fit.returncode == 0, fit.stderr[-2000:]
    assert f"(fingerprint {fp})" in fit.stdout
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    show = _cli("show", ours)
    assert show.returncode == 0 and f"(fingerprint {fp})" in show.stdout
    assert "raw err %" in show.stdout
    ok = _cli("validate", ours, "--fixture", "--published")
    assert ok.returncode == 0 and f"(fingerprint {fp})" in ok.stdout
    # stored statistics that the supplied measurements do not reproduce
    bad = _cli("validate", ours, "--published")
    assert bad.returncode == 1 and "INVALID" in bad.stdout


def test_example_is_the_committed_report(tmp_path):
    out = tmp_path / "example_calibration.md"
    r = _cli("example", "--out", out)
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.read_bytes() == EXAMPLE.read_bytes()
    assert example_markdown() == ref_example() == EXAMPLE.read_text()


def test_chip_smoke_peaks_are_the_h100_spec(chip_smoke):
    """The script's bounds and the calibration rows it writes use one peak."""
    import torch
    assert chip_smoke.PEAK_FLOPS[torch.bfloat16] == H100.peak_flops
    assert chip_smoke.HBM_BYTES_PER_S == H100.hbm_bw


#: (name, bytes, operations, measured s): a compute row, a bandwidth row, a
#: row whose two terms tie (the compute axis), and the SSD row's shape.
ROWS = [("matmul.prefill.M2048.K3072.N12288", 2 * (2048 * 3072 + 3072 * 12288 + 2048 * 12288),
         2 * 2048 * 3072 * 12288, 2.4e-4),
        ("matmul.tick.M4.K3072.N12288", 2 * (4 * 3072 + 3072 * 12288 + 4 * 12288),
         2 * 4 * 3072 * 12288, 3.1e-5),
        ("tie", 3350.0, 989000.0, 1.5e-9),
        ("ssd.prefill", 43_255_360.0, 1.2e10, 5.5e-5)]


def test_bench_rows_read_as_the_reference_reads_them(chip_smoke, tmp_path):
    rows = [chip_smoke.calib_row(*r) for r in ROWS]
    axes = [dict(t.split("=") for t in r["derived"].split(";"))["calib_axis"] for r in rows]
    assert axes == ["compute", "bandwidth", "compute", "bandwidth"]
    bench = chip_smoke.calib_bench(rows)
    assert list(bench["benchmarks"]) == ["h100_kernels"]
    ours, theirs = port.bench_measurements(bench), ref.bench_measurements(bench)
    assert _ms(ours) == _ms(theirs) and len(ours) == len(ROWS)
    for m, (name, nbytes, ops, meas) in zip(ours, ROWS):
        assert m.part == "h100" and m.workload == name and m.measured_s == meas
        assert m.predicted_s == max(ops / H100.peak_flops, nbytes / H100.hbm_bw)
        assert m.provenance.source == f"benchmarks/run.py:{name}"
    assert port.fit_corrections(ours).as_dict() == ref.fit_corrections(theirs).as_dict()
    path = tmp_path / "h100_kernels.json"
    path.write_text(json.dumps(bench))
    out = tmp_path / "h100.json"
    r = _cli("fit", "--bench", path, "--out", out)
    assert r.returncode == 0, r.stderr[-2000:]
    assert port.Calibration.load(out).as_dict() == port.fit_corrections(ours).as_dict()
    assert _cli("validate", out, "--bench", path).returncode == 0


@pytest.mark.parametrize("arch,shape,mesh", [("starcoder2-3b", "prefill_32k", "single_pod_16x16"),
                                             ("zamba2-2.7b", "prefill_32k", "multi_pod_2x16x16")])
def test_dryrun_artifacts_read_as_the_reference_reads_them(arch, shape, mesh, tmp_path):
    """One ``status: ok`` artifact of the port's dry run (a reduced cell on a
    fake (2, 2) mesh, named by a production mesh since the readers take only
    those) beside a skipped and a failed one: both packages read one
    measurement, the same."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape, mesh.startswith("multi"), device_type="cpu",
                          mesh_shape=(2, 2), reduced=True)
    assert rec["status"] == "ok" and {"flops", "coll_total", "mem_bytes"} <= set(rec["exact"])
    rec["mesh"] = mesh
    (tmp_path / f"{arch}__{shape}.json").write_text(json.dumps(rec, indent=1))
    (tmp_path / "skipped.json").write_text(json.dumps(
        dryrun.run_cell("starcoder2-3b", "long_500k", False, device_type="cpu")))
    (tmp_path / "error.json").write_text(json.dumps({"arch": arch, "shape": shape,
                                                     "mesh": "single", "status": "error"}))
    ours = port.hlo_dryrun_measurements(str(tmp_path))
    theirs = ref.hlo_dryrun_measurements(str(tmp_path))
    assert len(ours) == 1 and _ms(ours) == _ms(theirs)
    assert ours[0].workload == f"{arch}/{shape}@{mesh}" and ours[0].axis == "compute"
    assert _cli("fit", "--dryrun-dir", tmp_path, "--out", tmp_path / "c.json").returncode == 0
