"""The port's copy of the paper's network table (``repro_torch.core.netinfo``:
the ten nets of ``TABLE1_NETS`` and ``INPUT_CASES``) against
``repro.core.netinfo`` layer for layer, and the port's screen on every
Table 1 net bit-equal (``np.array_equal``) to the NumPy reference,
``repro.core.batch_eval.screen_rav_batch``. The screen runs on the CPU
here; chip_smoke.py phase J holds the card to the CPU on these cells."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import hw_specs as jax_hw  # noqa: E402
from repro.core import netinfo as jax_netinfo  # noqa: E402
from repro.core.batch_eval import screen_rav_batch  # noqa: E402
from repro.core.search import SearchSpace  # noqa: E402
from repro_torch.core import hw_specs, netinfo, screen  # noqa: E402

NETS = sorted(jax_netinfo.TABLE1_NETS)
BUILDERS = ["alexnet", "googlenet", "inception_v3", "resnet18", "resnet50", "squeezenet",
            "mobilenet", "mobilenet_v2", "yolo", "zfnet"]


def _same(a, b):
    assert a.name == b.name and a.input_hw == b.input_hw and a.input_c == b.input_c
    assert [dataclasses.astuple(x) for x in a.layers] == [dataclasses.astuple(x) for x in b.layers]
    assert (a.total_ops, a.ctc_list(16, 16), a.ctc_list(8, 8), a.major_indices) == \
        (b.total_ops, b.ctc_list(16, 16), b.ctc_list(8, 8), b.major_indices)


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_matches_reference(name):
    _same(getattr(netinfo, name)(), getattr(jax_netinfo, name)())


def test_table1_and_input_cases_match_reference():
    assert list(netinfo.TABLE1_NETS) == list(jax_netinfo.TABLE1_NETS)
    for name in NETS:
        _same(netinfo.TABLE1_NETS[name](), jax_netinfo.TABLE1_NETS[name]())
    assert netinfo.INPUT_CASES == jax_netinfo.INPUT_CASES


def test_screen_bit_equal_on_every_table1_net():
    """Each Table 1 net at its native input, on two boards and both
    precisions, stacked into one screen call (tables of ten lengths)."""
    cells = [(name, fp, prec) for name in NETS for fp, prec in (("ku115", 16), ("zcu102", 8))]
    rng = np.random.default_rng(21)
    tables, blocks = [], []
    for name, fp, prec in cells:
        net = netinfo.TABLE1_NETS[name]()
        tables.append(screen.cell_tables(net, hw_specs.FPGAS[fp], prec, prec))
        sp = SearchSpace(sp_max=len(net.major_layers), batch_max=8)
        blocks.append(np.concatenate([rng.uniform(sp.lo(), sp.hi(), size=(61, 5)),
                                      np.stack([sp.lo(), sp.hi(), sp.canonical()[1]])]))
    out = screen.screen_cells(screen.stack_cells(tables), np.stack(blocks), device="cpu")
    assert out.shape == (len(cells), 64) and out.dtype == np.float64
    for i, (name, fp, prec) in enumerate(cells):
        ref = screen_rav_batch(jax_netinfo.TABLE1_NETS[name](), jax_hw.FPGAS[fp], blocks[i],
                               prec, prec)
        assert np.array_equal(out[i], ref), f"{name} on {fp} at {prec} bits diverged"
