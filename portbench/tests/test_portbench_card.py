"""On the card (the ``cuda`` marker; skipped without one): at each cell's
own size, the program correct and the control (the reference in float8 in
the program's place, judged by the same comparison) not correct; and a
traced run through the command line reporting every per-layer metric."""
import json
import subprocess
import sys

import pytest
import torch

from portbench.harness import runner, spec

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    _card()
    result, read = runner.run_cell(spec.cell(cell), 2**31 + 29, 10.0, False, control=True)
    assert result["correct"], result["compared"]
    assert not read["control"]["correct"], read["control"]["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_every_per_layer_metric(cell):
    _card()
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 31), "--seconds", "5", "--trace", "1"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert set(line["metrics"]) == {m["name"] for m in spec.cell(cell).per_layer}
    assert len(line["breakdown"]["device_ops"]) > 0
