"""The port's DSE modules are copies of the JAX package's: byte for byte but
for the import prefix (``repro.`` -> ``repro_torch.`` on import lines) and
the lines ``CHANGED`` lists (a CLI's ``prog``), and where a module is cut or
changed (``core/__init__``, ``dse/campaign``, ``dse/cli``), the parts that
stay agree with the reference's. ``dse/backends.py`` is the reference's
whole but for the one renaming (``prescreen_cells_jax`` ->
``prescreen_cells``). The packages export the reference's names. The
port's screen reads its own copy of ``batch_eval``'s tables and is held to
its ``screen_rav_batch``."""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.calib as ref_calib  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.dse as ref_dse  # noqa: E402
import repro.dse.backends as ref_backends  # noqa: E402
import repro.dse.campaign as ref_campaign  # noqa: E402
import repro_torch.calib as port_calib  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.dse as port_dse  # noqa: E402
from repro_torch.core import batch_eval, hw_specs, screen  # noqa: E402
from repro_torch.core.layer_arrays import pack_layers  # noqa: E402
from repro_torch.dse import backends, campaign  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

VERBATIM = ["core/hw_specs.py", "core/pipeline_model.py", "core/generic_model.py",
            "core/local_opt.py", "core/layer_arrays.py", "core/batch_eval.py",
            "core/search.py", "core/pso.py", "core/explorer.py",
            "obs/trace.py", "obs/__init__.py", "testing/faults.py", "testing/__init__.py",
            "dse/pareto.py", "dse/frontier.py", "dse/objectives.py", "dse/store.py",
            "dse/resilience.py", "dse/__main__.py", "calib/calibration.py",
            "core/tpu_model.py", "core/tpu_planner.py", "core/gpu_model.py",
            "core/gpu_planner.py", "dse/report.py", "dse/obs.py", "dse/placement.py",
            "calib/fit.py", "calib/measure.py", "calib/published.py", "calib/__main__.py"]

#: The lines a copy changes beyond its imports: (port line, reference line).
CHANGED = {
    "dse/report.py": [('prog="python -m repro_torch.dse.report"',
                       'prog="python -m repro.dse.report"')],
    "dse/obs.py": [('prog="python -m repro_torch.dse.obs"', 'prog="python -m repro.dse.obs"')],
    "dse/placement.py": [('prog="python -m repro_torch.dse.placement"',
                          'prog="python -m repro.dse.placement"')],
    "calib/__main__.py": [('prog="python -m repro_torch.calib"', 'prog="python -m repro.calib"')],
    "dse/backends.py": [("(:func:`repro_torch.dse.campaign.prescreen_cells`)",
                         "(:func:`repro.dse.campaign.prescreen_cells`)")],
}

_PORT_IMPORT = re.compile(r"^(\s*(?:from|import) )repro_torch(?=[ .])", re.MULTILINE)


def _as_reference(path: str) -> str:
    """The port's copy with its import lines and its ``CHANGED`` lines put back."""
    text = _PORT_IMPORT.sub(r"\1repro", (PORT / path).read_text())
    for ours, theirs in CHANGED.get(path, []):
        assert text.count(ours) == 1, (path, ours)
        text = text.replace(ours, theirs)
    return text


@pytest.mark.parametrize("path", VERBATIM)
def test_dse_module_is_a_verbatim_copy(path):
    """Each module is the reference's with only its import lines (and the
    lines ``CHANGED`` lists) rewritten."""
    port = (PORT / path).read_text()
    assert _as_reference(path) == (REF / path).read_text()
    assert "import repro." not in port.replace("import repro_torch", "")


def test_backends_is_the_references_whole():
    """``dse/backends.py`` is the reference's file: imports rewritten, the
    cross-cell screen's one renaming, nothing else; every backend is
    registered and none is refused."""
    ref = (REF / "dse/backends.py").read_text().replace("prescreen_cells_jax", "prescreen_cells")
    assert _as_reference("dse/backends.py") == ref
    assert sorted(backends.BACKENDS) == sorted(ref_backends.BACKENDS) == ["cuda", "fpga", "tpu"]
    assert not hasattr(backends, "UNPORTED_BACKENDS")


@pytest.mark.parametrize("pkg", ["calib", "dse"])
def test_package_exports_the_references_names(pkg):
    port, ref = {"calib": (port_calib, ref_calib), "dse": (port_dse, ref_dse)}[pkg]
    assert port.__all__ == [n.replace("prescreen_cells_jax", "prescreen_cells")
                            for n in ref.__all__]
    for name in port.__all__:
        ours = getattr(port, name)
        theirs = getattr(ref, name.replace("prescreen_cells", "prescreen_cells_jax"))
        assert type(ours).__name__ == type(theirs).__name__
        assert getattr(ours, "__name__", name) == getattr(theirs, "__name__", name).replace(
            "prescreen_cells_jax", "prescreen_cells")


def test_core_exports_the_references_names():
    assert port_core.__all__ == ref_core.__all__
    for name in port_core.__all__:
        assert type(getattr(port_core, name)).__name__ == type(getattr(ref_core, name)).__name__


@pytest.mark.parametrize("name", ["parse_inputs", "parse_searcher_config", "parse_weights",
                                  "_csv", "stamp_calibration", "run_cell_by_backend"])
def test_backend_functions_are_the_references(name):
    """The kept functions of backends.py are the reference's, line for line
    (the lazy imports inside ``run_cell_by_backend`` and one docstring
    cross-reference rewritten)."""
    port = inspect.getsource(getattr(backends, name)).replace("repro_torch.", "repro.")
    ref = inspect.getsource(getattr(ref_backends, name))
    assert port == ref.replace("prescreen_cells_jax", "prescreen_cells")


@pytest.mark.parametrize("name", sorted(set(vars(ref_backends.FPGABackend))
                                        - {"__doc__", "__module__", "__abstractmethods__",
                                           "_abc_impl"}))
def test_fpga_backend_is_the_references(name):
    port, ref = vars(backends.FPGABackend)[name], vars(ref_backends.FPGABackend)[name]
    if callable(ref):
        assert inspect.getsource(port) == inspect.getsource(ref)
    else:
        assert repr(port) == repr(ref)


@pytest.mark.parametrize("name", ["build_net", "expand_cells", "cell_seed", "_search_config",
                                  "CampaignCell", "CampaignReport"])
def test_campaign_functions_are_the_references(name):
    assert inspect.getsource(getattr(campaign, name)) == \
        inspect.getsource(getattr(ref_campaign, name))


def test_run_cell_differs_only_in_docstring():
    strip = lambda f: inspect.getsource(f).split('"""')[2]  # noqa: E731
    assert strip(campaign.run_cell) == strip(ref_campaign.run_cell)


@pytest.mark.parametrize("net,h,fpga,prec", [("vgg16", 224, "ku115", 16), ("vgg19", 128, "zcu102", 8),
                                             ("alexnet", 0, "zc706", 16),
                                             ("resnet18", 0, "vu9p", 8)])
def test_screen_matches_the_ports_batch_eval(net, h, fpga, prec):
    """``screen.cell_tables`` reads the port's own packed layers and
    ``batch_eval`` tables, and the screen over them is the port's
    ``batch_eval.screen_rav_batch`` to the bit."""
    from repro_torch.core.search import SearchSpace
    n = campaign.build_net(net, h, h)
    packed = pack_layers(n, prec, prec)
    ours = screen.cell_tables(n, hw_specs.FPGAS[fpga], prec, prec)
    assert (ours["n_major"], ours["n_layers"], ours["ifm0"]) == \
        (packed.n_major, packed.n_layers, float(packed.ifm0))
    sp = SearchSpace(sp_max=len(n.major_layers), batch_max=8)
    block = np.random.default_rng(5).uniform(sp.lo(), sp.hi(), size=(97, 5))
    got = screen.screen_cells(screen.stack_cells([ours]), block[None], device="cpu")[0]
    assert np.array_equal(got, batch_eval.screen_rav_batch(n, hw_specs.FPGAS[fpga], block,
                                                           prec, prec))
