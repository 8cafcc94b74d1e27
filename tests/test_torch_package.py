"""The port stands alone: importing it loads no JAX and nothing of the JAX
package, its sources and chip_smoke.py import neither, and chip_smoke.py
refuses to run without a CUDA device instead of falling back to the CPU."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro([ .,]|$)|from repro[ .])",
                       re.MULTILINE)


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_import_loads_no_jax_and_no_reference():
    mods = _modules()
    assert "repro_torch.kernels.conv2d.ops" in mods and "repro_torch.models.cnn" in mods
    assert {"repro_torch.configs", "repro_torch.kernels.matmul.ops",
            "repro_torch.kernels.rmsnorm.ops", "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.ssd.ops", "repro_torch.models.ssm",
            "repro_torch.models.recurrent", "repro_torch.configs.zamba2_2_7b",
            "repro_torch.models.transformer", "repro_torch.models.api",
            "repro_torch.serve.scheduler", "repro_torch.launch.serve",
            "repro_torch.models.moe", "repro_torch.models.encdec", "repro_torch.serve.quant",
            "repro_torch.train.hybrid", "repro_torch.configs.xlstm_350m",
            "repro_torch.configs.whisper_base", "repro_torch.configs.kimi_k2_1t_a32b",
            "repro_torch.configs.llama4_maverick_400b_a17b",
            "repro_torch.core.batch_eval", "repro_torch.core.search", "repro_torch.core.pso",
            "repro_torch.core.explorer", "repro_torch.dse", "repro_torch.dse.campaign",
            "repro_torch.dse.cli", "repro_torch.dse.backends", "repro_torch.dse.store",
            "repro_torch.dse.resilience", "repro_torch.obs", "repro_torch.obs.trace",
            "repro_torch.calib", "repro_torch.calib.calibration", "repro_torch.testing",
            "repro_torch.testing.faults"} <= set(mods)
    # a __main__ module runs its CLI when imported
    mods = [m for m in mods if not m.endswith(".__main__")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'jaxlib' or m.startswith('jaxlib.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT))
                                        for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax(path):
    assert not FORBIDDEN.findall((ROOT / path).read_text()), path


def _run_smoke(script, cwd):
    # No visible card: the run must stop, whatever the machine holds.
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_cuda():
    r = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "CUDA" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


KERNELS = ["conv2d", "matmul", "rmsnorm", "flash_attention", "ssd"]


def test_every_kernel_is_built_from_its_source():
    from repro_torch.kernels import _build
    assert sorted(_build.sources()) == sorted(KERNELS)


def test_shared_header_is_in_every_kernel_target(tmp_path, monkeypatch):
    """An edit to a shared header (kernels/include) gives every kernel a new
    cache key, so no stale library is loaded; nvcc gets the directory."""
    import shutil
    from repro_torch.kernels import _build
    inc = tmp_path / "include"
    shutil.copytree(_build.INCLUDE_DIR, inc)
    monkeypatch.setattr(_build, "INCLUDE_DIR", inc)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    srcs = _build.sources()
    before = {name: _build._target(src) for name, src in srcs.items()}
    assert before == {name: _build._target(src) for name, src in srcs.items()}
    header = inc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._target(src) for name, src in srcs.items()}
    assert all(after[name] != before[name] for name in srcs)
    cmd = _build.command(srcs["conv2d"], tmp_path / "lib.so")
    assert cmd[cmd.index("-I") + 1] == str(inc)


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_source_carries_its_note(name):
    """Each source names the TPU kernel it replaces, what bounds it on the
    card and what its design does about that."""
    text = (PORT / "kernels" / name / "csrc" / f"{name}.cu").read_text()
    assert f"repro/kernels/{name}/" in text
    assert "What bounds it on the H100" in text and "What the design does about it" in text
    assert "cudaGetLastError" in text


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_wrapper_counts_launches(name):
    import importlib
    ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    assert isinstance(getattr(ops, name).launches, int)


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "src" / "repro" / "configs")
                                         .glob("*.py") if p.name != "__init__.py"))
def test_config_base_is_a_verbatim_copy(name):
    """base.py and every architecture's config module are the reference's, byte for byte."""
    assert (PORT / "configs" / name).read_text() == \
        (ROOT / "src" / "repro" / "configs" / name).read_text()


@pytest.mark.parametrize("name", ["all_configs", "cell_enabled"])
def test_registry_functions_are_verbatim_copies(name):
    """The registry's ``all_configs`` and ``cell_enabled`` are the reference's,
    line for line (comments included)."""
    import inspect

    import repro.configs as ref
    import repro_torch.configs as port
    assert inspect.getsource(getattr(port, name)) == inspect.getsource(getattr(ref, name))
    assert name in port.__all__
    assert list(port.all_configs()) == list(ref.all_configs())


def _cells():
    from repro.configs import ARCH_IDS, SHAPES
    return [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", _cells())
def test_cell_enabled_agrees_with_the_reference(arch, shape):
    """The same (ok, why) for every (arch x shape) cell: long_500k runs only
    for the sub-quadratic archs (SWA, SSM, hybrid)."""
    import repro.configs as ref
    import repro_torch.configs as port
    ok, why = port.cell_enabled(port.get_config(arch), port.SHAPES[shape])
    assert (ok, why) == ref.cell_enabled(ref.get_config(arch), ref.SHAPES[shape])
    assert ok == (shape != "long_500k"
                  or arch in ("h2o-danube-3-4b", "xlstm-350m", "zamba2-2.7b"))
