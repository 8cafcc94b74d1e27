"""The port's DSE campaign (``repro_torch.dse.campaign``) against the JAX
package's (``repro.dse.campaign.run_campaign``, which screens hyperband's
rung 0 per cell in NumPy here): the same records, field for field but the
search time, for PSO and for hyperband, screened per cell
(``screen_device=None``) and in one cross-cell call on the CPU
(``"cpu"``); stores that either package resumes from the other; no silent
fallback (a CUDA screen without CUDA raises); quarantine and
``--retry-failed``; the CLI in a subprocess that loads no JAX and nothing
of the JAX package."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.dse import campaign as ref  # noqa: E402
from repro_torch.dse import campaign as port  # noqa: E402
from repro_torch.dse.cli import exit_code  # noqa: E402
from repro_torch.dse.store import is_ok, open_store  # noqa: E402
from repro_torch.testing.faults import ENV_VAR, Fault, FaultPlan  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRID = (["vgg16", "alexnet"], [(224, 224)], ["ku115", "zcu102"], [16], [1])
PSO = dict(population=6, iterations=3)
HYPERBAND = dict(searcher="hyperband", searcher_config={"screen": 256, "survivors": 4})
SEARCHES = {"pso": PSO, "hyperband": HYPERBAND}


def _strip(records):
    return [{k: v for k, v in r.items() if k != "search_time_s"} for r in records]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's campaign records, one run per searcher."""
    d = tmp_path_factory.mktemp("ref")
    return {name: ref.run_campaign(ref.expand_cells(*GRID), str(d / f"{name}.jsonl"), **kw)
            for name, kw in SEARCHES.items()}


@pytest.mark.parametrize("searcher,screen_device", [("pso", None), ("hyperband", None),
                                                    ("hyperband", "cpu")])
def test_records_equal_the_references(reference, tmp_path, searcher, screen_device):
    cells = port.expand_cells(*GRID)
    assert [c.key for c in cells] == [c.key for c in reference[searcher].cells]
    kw = dict(SEARCHES[searcher])
    if searcher == "hyperband":
        kw["screen_device"] = screen_device
    got = port.run_campaign(cells, str(tmp_path / "s.jsonl"), **kw)
    want = reference[searcher]
    assert len(got.records) == len(cells) == 4
    assert _strip(got.records) == _strip(want.records)
    assert got.new_evaluations == want.new_evaluations > 0
    assert [r["cell_key"] for r in got.ranked()] == [r["cell_key"] for r in want.ranked()]
    assert [r["cell_key"] for r in got.frontier()] == [r["cell_key"] for r in want.frontier()]


@pytest.mark.parametrize("searcher", ["pso", "hyperband"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_resumes_across_packages(tmp_path, searcher, writer):
    """The screen device stays out of the stored search config, so a store
    written by one package resumes in the other with 0 new evaluations."""
    store = str(tmp_path / "s.jsonl")
    kw = SEARCHES[searcher]
    port_kw = dict(kw, **({"screen_device": "cpu"} if searcher == "hyperband" else {}))
    if writer == "reference":
        first = ref.run_campaign(ref.expand_cells(*GRID), store, **kw)
        again = port.run_campaign(port.expand_cells(*GRID), store, **port_kw)
    else:
        first = port.run_campaign(port.expand_cells(*GRID), store, **port_kw)
        again = ref.run_campaign(ref.expand_cells(*GRID), store, **kw)
    assert first.new_cells == 4
    assert (again.new_cells, again.reused_cells, again.new_evaluations) == (0, 4, 0)
    assert again.records == first.records


def test_prescreen_equals_the_searchers_rung0():
    """``prescreen_cells`` scores each cell's rung-0 block as the searcher's
    own NumPy screen does, to the bit."""
    import numpy as np

    from repro_torch.core.batch_eval import screen_rav_batch
    from repro_torch.core.hw_specs import FPGAS
    from repro_torch.core.pso import PSOConfig
    from repro_torch.core.search import SearchSpace, hyperband_rung0, searcher_config_for
    cells = port.expand_cells(["vgg16", "vgg19", "alexnet"], [(128, 160)], ["zc706", "vu9p"],
                              [8, 16], [1, 4])
    fits = port.prescreen_cells(cells, base_seed=7, searcher_config={"screen": 300},
                                device="cpu")
    assert list(fits) == [c.key for c in cells]
    for c in cells:
        net = port.build_net(c.net, c.h, c.w)
        pso = PSOConfig(seed=port.cell_seed(7, c))
        cfg = searcher_config_for("hyperband", base=dict(population=pso.population,
                                                         iterations=pso.iterations,
                                                         patience=pso.patience, seed=pso.seed),
                                  overrides={"screen": 300})
        block = hyperband_rung0(SearchSpace(sp_max=len(net.major_layers),
                                            batch_max=c.batch_max), cfg)
        assert fits[c.key].shape == (300,)
        assert np.array_equal(fits[c.key], screen_rav_batch(net, FPGAS[c.fpga], block,
                                                            c.precision, c.precision))


def test_cuda_screen_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cells = port.expand_cells(["vgg16"], [(224, 224)], ["ku115"], [16], [1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.run_campaign(cells, str(tmp_path / "a.jsonl"), **HYPERBAND, screen_device="cuda")
    # the default for a hyperband campaign is the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.run_campaign(cells, str(tmp_path / "b.jsonl"), **HYPERBAND)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.prescreen_cells(cells, device="cuda")
    assert not (tmp_path / "a.jsonl").exists() and not (tmp_path / "b.jsonl").exists()


@pytest.mark.parametrize("screen_device", ["cpu", "cuda"])
def test_screen_device_with_another_searcher_raises(tmp_path, screen_device):
    cells = port.expand_cells(["vgg16"], [(224, 224)], ["ku115"], [16], [1])
    with pytest.raises(ValueError, match="hyperband"):
        port.run_campaign(cells, str(tmp_path / "s.jsonl"), **PSO, screen_device=screen_device)


def test_permanent_fault_quarantines_and_retry_failed_clears_it(tmp_path, monkeypatch):
    cells = port.expand_cells(["vgg16"], [(224, 224)], ["ku115", "zcu102"], [16], [1])
    store = str(tmp_path / "s.jsonl")
    plan = FaultPlan({cells[0].key: Fault("raise-permanent")})
    monkeypatch.setenv(ENV_VAR, str(plan.save(tmp_path / "p.json")))
    first = port.run_campaign(cells, store, **PSO)
    assert first.partial and first.failed_cells == 1 and exit_code(first) == 3
    assert [r["cell_key"] for r in first.failures()] == [cells[0].key]
    monkeypatch.delenv(ENV_VAR)
    sticky = port.run_campaign(cells, store, **PSO)
    assert sticky.new_cells == 0 and sticky.failed_cells == 1
    cleared = port.run_campaign(cells, store, retry_failed=True, **PSO)
    assert cleared.new_cells == 1 and cleared.failed_cells == 0 and exit_code(cleared) == 0
    assert is_ok(open_store(store).get(cells[0].key))


def test_pool_workers_take_the_parents_screen(tmp_path):
    """With two workers the screen runs in the parent; the spawned workers
    import the port by module path and give the serial run's records."""
    cells = port.expand_cells(["vgg16"], [(224, 224)], ["ku115", "zcu102"], [16], [1])
    serial = port.run_campaign(cells, str(tmp_path / "a.jsonl"), **HYPERBAND,
                               screen_device="cpu")
    pooled = port.run_campaign(cells, str(tmp_path / "b.jsonl"), **HYPERBAND,
                               screen_device="cpu", workers=2)
    assert _strip(pooled.records) == _strip(serial.records)


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


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", _CLI, *args], env=env, capture_output=True,
                          text=True, timeout=240, cwd=ROOT)


def test_cli_runs_and_resumes_without_jax(tmp_path):
    store = tmp_path / "t.jsonl"
    args = ["--nets", "vgg16", "--fpgas", "ku115,zcu102", "--precisions", "16,8",
            "--searcher", "hyperband", "--searcher-config", "screen=256,survivors=4",
            "--device", "cpu", "--store", str(store)]
    first = _cli(*args)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "LOADED []" in first.stdout
    assert "screened 4 cells x 256 rung-0 candidates in one call on cpu" in first.stdout
    assert "-- top 8 by scalarized objective" in first.stdout
    assert "net=vgg16|in=224x224|fpga=ku115|prec=8|bmax=1" in first.stdout
    assert "(4 new, 0 reused;" in first.stdout
    recs = [json.loads(line) for line in store.read_text().splitlines()]
    assert len(recs) == 4 and all(r["search"]["searcher"] == "hyperband" for r in recs)
    again = _cli(*args)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "(0 new, 4 reused; 0 new evaluations" in again.stdout
    assert "screened" not in again.stdout
