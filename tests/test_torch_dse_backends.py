"""The port's tpu and cuda campaign backends against the JAX package's: the
analytic models and planners they evaluate (``core/tpu_model``,
``core/tpu_planner``, ``core/gpu_model``, ``core/gpu_planner``) give the
reference's numbers; the same grid through ``repro.dse.campaign.run_campaign``
and ``repro_torch.dse.campaign.run_campaign`` gives the same records, field
for field but the search time, uncalibrated and under the fixture
calibration; each package resumes the other's store; and ``--backend
tpu|cuda`` on the port's CLI exits 0 with the reference's table rows,
loading no JAX and nothing of the JAX package."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.calib as ref_calib  # noqa: E402
import repro.configs as ref_configs  # noqa: E402
from repro.core import gpu_model as ref_gpu_model  # noqa: E402
from repro.core import gpu_planner as ref_gpu_planner  # noqa: E402
from repro.core import hw_specs as ref_hw  # noqa: E402
from repro.core import tpu_model as ref_tpu_model  # noqa: E402
from repro.core import tpu_planner as ref_tpu_planner  # noqa: E402
from repro.dse import backends as ref_backends  # noqa: E402
from repro.dse import campaign as ref  # noqa: E402

import repro_torch.calib as port_calib  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.core import gpu_model, gpu_planner, hw_specs, tpu_model, tpu_planner  # noqa: E402
from repro_torch.dse import backends  # noqa: E402
from repro_torch.dse import campaign as port  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("starcoder2-3b", "zamba2-2.7b")
SHAPES = ("train_4k", "decode_32k")
COUNTS = (8, 16)
GRIDS = {"tpu": dict(archs=ARCHS, shapes=SHAPES, chips=COUNTS),
         "cuda": dict(archs=ARCHS, shapes=SHAPES, gpus=COUNTS, gpu_types=("a100-80g", "h100"))}
MODEL_CELLS = [(a, s) for a in ("starcoder2-3b", "zamba2-2.7b", "xlstm-350m", "whisper-base",
                                "kimi-k2-1t-a32b")
               for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]


def _strip(records):
    return [{k: v for k, v in r.items() if k != "search_time_s"} for r in records]


def _plain(obj):
    """A dataclass (of either package) as nested dicts, its class named."""
    if dataclasses.is_dataclass(obj):
        return {"class": type(obj).__name__, **{f.name: _plain(getattr(obj, f.name))
                                                for f in dataclasses.fields(obj)}}
    return obj


@pytest.fixture(scope="module")
def calibrations():
    """The fixture calibration fitted by each package: the same fingerprint."""
    ours = port_calib.fit_corrections(port_calib.fixture_measurements())
    theirs = ref_calib.fit_corrections(ref_calib.fixture_measurements())
    assert ours.fingerprint() == theirs.fingerprint()
    return {False: (None, None), True: (ours, theirs)}


@pytest.mark.parametrize("arch,shape", MODEL_CELLS)
def test_analytic_rooflines_are_the_references(arch, shape):
    cfg, rcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    sh, rsh = port_configs.SHAPES[shape], ref_configs.SHAPES[shape]
    for mesh in (tpu_model.MeshDesc.single_pod(), tpu_model.MeshDesc(8, 2, 4),
                 tpu_model.MeshDesc(1, 1, 1)):
        rmesh = ref_tpu_model.MeshDesc(mesh.n_chips, mesh.dp, mesh.tp)
        assert _plain(tpu_model.analytic_roofline(cfg, sh, mesh)) == \
            _plain(ref_tpu_model.analytic_roofline(rcfg, rsh, rmesh))
        assert tpu_model.useful_flops(cfg, sh) == ref_tpu_model.useful_flops(rcfg, rsh)
        for name in sorted(hw_specs.GPUS):
            assert _plain(gpu_model.analytic_roofline(cfg, sh, mesh, hw_specs.GPUS[name])) == \
                _plain(ref_gpu_model.analytic_roofline(rcfg, rsh, rmesh, ref_hw.GPUS[name]))
    exact = {"flops": 3.5e14, "coll_total": 2.5e10, "mem_bytes": 7.5e11}
    assert _plain(tpu_model.hlo_roofline(exact)) == _plain(ref_tpu_model.hlo_roofline(exact))


@pytest.mark.parametrize("arch,shape", [("starcoder2-3b", "train_4k"),
                                        ("zamba2-2.7b", "decode_32k"),
                                        ("xlstm-350m", "prefill_32k")])
def test_planners_are_the_references(arch, shape, calibrations):
    """plan_arch over the whole mesh space, and evaluate_point under the
    fixture calibration, on the TPU and on each GPU part."""
    cfg, rcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    sh, rsh = port_configs.SHAPES[shape], ref_configs.SHAPES[shape]
    assert list(tpu_planner.candidate_meshes(64)) == list(ref_tpu_planner.candidate_meshes(64))
    assert [_plain(p) for p in tpu_planner.plan_arch(cfg, sh, max_chips=64)] == \
        [_plain(p) for p in ref_tpu_planner.plan_arch(rcfg, rsh, max_chips=64)]
    ours, theirs = calibrations[True]
    assert _plain(tpu_planner.evaluate_point(cfg, sh, 16, 4, 4, "dots", 2, calibration=ours)) \
        == _plain(ref_tpu_planner.evaluate_point(rcfg, rsh, 16, 4, 4, "dots", 2,
                                                 calibration=theirs))
    for name in sorted(hw_specs.GPUS):
        hw, rhw = hw_specs.GPUS[name], ref_hw.GPUS[name]
        assert [_plain(p) for p in gpu_planner.plan_arch(cfg, sh, hw, max_gpus=32)] == \
            [_plain(p) for p in ref_gpu_planner.plan_arch(rcfg, rsh, rhw, max_gpus=32)]
        assert _plain(gpu_planner.evaluate_point(cfg, sh, 16, 2, 8, "full", 1, hw,
                                                 calibration=ours)) == \
            _plain(ref_gpu_planner.evaluate_point(rcfg, rsh, 16, 2, 8, "full", 1, rhw,
                                                  calibration=theirs))


@pytest.mark.parametrize("calibrated", [False, True], ids=["datasheet", "calibrated"])
@pytest.mark.parametrize("backend", ["tpu", "cuda"])
def test_campaign_records_equal_the_references(backend, calibrated, calibrations, tmp_path):
    ours, theirs = calibrations[calibrated]
    cells = backends.get_backend(backend).expand_cells(**GRIDS[backend])
    ref_cells = ref_backends.get_backend(backend).expand_cells(**GRIDS[backend])
    assert [c.key for c in cells] == [c.key for c in ref_cells]
    got = port.run_campaign(cells, str(tmp_path / "p.jsonl"), backend=backend,
                            calibration=ours)
    want = ref.run_campaign(ref_cells, str(tmp_path / "r.jsonl"), backend=backend,
                            calibration=theirs)
    assert len(got.records) == len(cells) == 40 * (2 if backend == "cuda" else 1)
    assert _strip(got.records) == _strip(want.records)
    assert got.new_evaluations == want.new_evaluations > 0
    assert [r["cell_key"] for r in got.ranked()] == [r["cell_key"] for r in want.ranked()]
    assert [r["cell_key"] for r in got.frontier()] == [r["cell_key"] for r in want.frontier()]
    if calibrated:
        assert all(r["search"]["calibration"] == ours.fingerprint() for r in got.records)
        assert any("calibration" in r for r in got.records)


@pytest.mark.parametrize("backend", ["tpu", "cuda"])
def test_each_package_resumes_the_others_store(backend, calibrations, tmp_path):
    ours, theirs = calibrations[True]
    cells = backends.get_backend(backend).expand_cells(**GRIDS[backend])
    ref_cells = ref_backends.get_backend(backend).expand_cells(**GRIDS[backend])
    first = ref.run_campaign(ref_cells, str(tmp_path / "r.jsonl"), backend=backend,
                             calibration=theirs)
    again = port.run_campaign(cells, str(tmp_path / "r.jsonl"), backend=backend,
                              calibration=ours)
    assert (again.new_cells, again.reused_cells, again.new_evaluations) == (0, len(cells), 0)
    assert again.records == first.records
    # another calibration is another search config: every cell runs anew
    fresh = port.run_campaign(cells, str(tmp_path / "r.jsonl"), backend=backend)
    assert fresh.new_cells == len(cells)


@pytest.mark.parametrize("gpu", sorted(hw_specs.GPUS))
def test_workload_families_and_coverage_are_the_references(gpu):
    cuda, rcuda = backends.get_backend("cuda"), ref_backends.get_backend("cuda")
    for key in ("starcoder2-3b/train_4k", "vgg16@224x224", "nope/none", "xlstm-350m/decode_32k"):
        assert backends.workload_families(key) == ref_backends.workload_families(key)
        assert [c.key for c in cuda.coverage_cells(key)] == \
            [c.key for c in rcuda.coverage_cells(key)]
    assert backends.enumeration_trace(7) == ref_backends.enumeration_trace(7)
    assert _plain(hw_specs.GPUS[gpu]) == _plain(ref_hw.GPUS[gpu])


_CLI = """
import runpy, sys
sys.argv = ["repro_torch.dse.campaign", *sys.argv[1:]]
try:
    runpy.run_module("repro_torch.dse.campaign", run_name="__main__")
except SystemExit as e:
    code = e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
sys.exit(code)
"""

CLI_GRIDS = {"tpu": ["--archs", "starcoder2-3b", "--shapes", "train_4k,decode_32k",
                     "--chips", "8,16"],
             "cuda": ["--archs", "starcoder2-3b", "--shapes", "train_4k,decode_32k",
                      "--gpus", "8,16", "--gpu-types", "a100-80g,h100"]}


def _rows(stdout: str) -> list:
    return sorted(line for line in stdout.splitlines() if line.startswith("arch="))


@pytest.mark.parametrize("backend", ["tpu", "cuda"])
def test_cli_prints_the_references_table(backend, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = ["--backend", backend, *CLI_GRIDS[backend], "-q"]
    mine = subprocess.run([sys.executable, "-c", _CLI, *args, "--store",
                           str(tmp_path / "p.jsonl")], env=env, capture_output=True, text=True,
                          timeout=240, cwd=ROOT)
    theirs = subprocess.run([sys.executable, "-m", "repro.dse.campaign", *args, "--store",
                             str(tmp_path / "r.jsonl")], env=env, capture_output=True,
                            text=True, timeout=240, cwd=ROOT)
    assert mine.returncode == 0, mine.stderr[-2000:]
    assert theirs.returncode == 0, theirs.stderr[-2000:]
    assert "LOADED []" in mine.stdout
    assert _rows(mine.stdout) and _rows(mine.stdout) == _rows(theirs.stdout)
    recs = [json.loads(line) for line in (tmp_path / "p.jsonl").read_text().splitlines()]
    assert all(r["backend"] == backend for r in recs)
    assert _strip(recs) == _strip(json.loads(line) for line in
                                  (tmp_path / "r.jsonl").read_text().splitlines())
