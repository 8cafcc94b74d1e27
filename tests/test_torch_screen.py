"""The port's cross-cell DSE screen (repro_torch.core.screen) against the
NumPy reference, ``repro.core.batch_eval.screen_rav_batch``: bit-equal
(``np.array_equal``), as ``tests/test_jax_screen.py`` holds the jax
screen. The tables of the four heterogeneous CASES come from the JAX
package's NumPy ``cell_tables`` (alexnet is not in the port's netinfo);
the port's own ``cell_tables``/``stack_cells`` are held to the
reference's array for array on VGG-16/VGG-19 cells. The screen runs on
the CPU here; chip_smoke.py phase J holds the card to the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hw_specs as jax_hw  # noqa: E402
from repro.core import netinfo as jax_netinfo  # noqa: E402
from repro.core import screen_jax  # noqa: E402
from repro.core.batch_eval import screen_rav_batch  # noqa: E402
from repro.core.search import SearchSpace, hyperband_rung0, searcher_config_for  # noqa: E402
from repro.dse.campaign import build_net, cell_seed, expand_cells, run_campaign, run_cell  # noqa: E402
from repro_torch.core import hw_specs, netinfo, screen  # noqa: E402
from tools.torch_prescreen import prescreen_cells_torch  # noqa: E402

# tests/test_jax_screen.py::CASES: different table lengths (vgg16, alexnet,
# vgg19), precisions (alpha 2 and 4) and boards.
CASES = [("vgg16", 224, 224, "ku115", 16),
         ("alexnet", 0, 0, "zcu102", 8),
         ("vgg19", 320, 320, "vu9p", 16),
         ("vgg16", 128, 128, "zc706", 8)]

# VGG cells built from both packages' netinfo: (net, input, board, precision).
VGG_CELLS = [("vgg16", 64, "ku115", 16), ("vgg16", 224, "zc706", 8),
             ("vgg19", 128, "vu9p", 16), ("vgg19", 448, "zcu102", 8),
             ("vgg16", 320, "zcu102", 16), ("vgg19", 224, "ku115", 8)]


def _spaces_and_tables():
    tables, spaces = [], []
    for net_name, h, w, fp, prec in CASES:
        net = build_net(net_name, h, w)
        spaces.append(SearchSpace(sp_max=len(net.major_layers), batch_max=8))
        tables.append(screen_jax.cell_tables(net, jax_hw.FPGAS[fp], prec, prec))
    return spaces, tables


def _nets(name: str, h: int):
    if name == "vgg16":
        return netinfo.vgg16(h), jax_netinfo.vgg16(h)
    return netinfo.vgg19(h, with_fc=False), jax_netinfo.vgg19(h, with_fc=False)


def test_bit_equivalence_vs_numpy_reference():
    spaces, tables = _spaces_and_tables()
    rng = np.random.default_rng(11)
    blocks = [rng.uniform(sp.lo(), sp.hi(), size=(311, 5)) for sp in spaces]
    out = screen.screen_cells(screen_jax.stack_cells(tables), np.stack(blocks), device="cpu")
    assert out.shape == (len(CASES), 311) and out.dtype == np.float64
    for i, (net_name, h, w, fp, prec) in enumerate(CASES):
        ref = screen_rav_batch(build_net(net_name, h, w), jax_hw.FPGAS[fp], blocks[i], prec, prec)
        assert np.array_equal(out[i], ref), f"cell {i} diverged"


def test_boundary_positions_bit_equal():
    """sp = 0 (no pipeline), the full split, near-zero fractions: every
    where-guard of the screen."""
    spaces, tables = _spaces_and_tables()
    blocks = []
    for sp in spaces:
        lo, hi = sp.lo(), sp.hi()
        blocks.append(np.stack([lo, hi, sp.canonical()[1],
                                [0.4, 1.0, 0.05, 0.05, 0.05],
                                [hi[0], hi[1], 0.95, 0.95, 0.05]]))
    out = screen.screen_cells(screen_jax.stack_cells(tables), np.stack(blocks), device="cpu")
    for i, (net_name, h, w, fp, prec) in enumerate(CASES):
        ref = screen_rav_batch(build_net(net_name, h, w), jax_hw.FPGAS[fp], blocks[i], prec, prec)
        assert np.array_equal(out[i], ref)


@pytest.mark.parametrize("cell", VGG_CELLS, ids=lambda c: "-".join(map(str, c)))
def test_cell_tables_match_reference(cell):
    name, h, fp, prec = cell
    ours, ref_net = _nets(name, h)
    a = screen.cell_tables(ours, hw_specs.FPGAS[fp], prec, prec)
    b = screen_jax.cell_tables(ref_net, jax_hw.FPGAS[fp], prec, prec)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_stack_cells_and_screen_match_reference():
    """The port's tables of every VGG cell, stacked by the port, screen as
    the NumPy reference does cell by cell."""
    ours, ref = [], []
    for name, h, fp, prec in VGG_CELLS:
        a, b = _nets(name, h)
        ours.append(screen.cell_tables(a, hw_specs.FPGAS[fp], prec, prec))
        ref.append(screen_jax.cell_tables(b, jax_hw.FPGAS[fp], prec, prec))
    s_ours, s_ref = screen.stack_cells(ours), screen_jax.stack_cells(ref)
    assert s_ours.keys() == s_ref.keys()
    for k in s_ours:
        assert np.array_equal(s_ours[k], s_ref[k]) and s_ours[k].dtype == s_ref[k].dtype, k
    rng = np.random.default_rng(5)
    blocks = np.stack([rng.uniform(SearchSpace(len(_nets(n, h)[0].major_layers), 8).lo(),
                                   SearchSpace(len(_nets(n, h)[0].major_layers), 8).hi(),
                                   size=(257, 5)) for n, h, _, _ in VGG_CELLS])
    out = screen.screen_cells(s_ours, blocks, device="cpu")
    for i, (name, h, fp, prec) in enumerate(VGG_CELLS):
        ref_out = screen_rav_batch(_nets(name, h)[1], jax_hw.FPGAS[fp], blocks[i], prec, prec)
        assert np.array_equal(out[i], ref_out), i


def test_fpgas_copy_matches_reference():
    assert list(hw_specs.FPGAS) == list(jax_hw.FPGAS)
    for name, spec in hw_specs.FPGAS.items():
        ref = jax_hw.FPGAS[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref)
        assert (spec.freq, spec.dsp_usable, spec.bram_usable, spec.bram_bits, spec.peak_gops(4)) \
            == (ref.freq, ref.dsp_usable, ref.bram_usable, ref.bram_bits, ref.peak_gops(4))
    assert [hw_specs.alpha_for(b) for b in (4, 8, 16, 32)] == \
        [jax_hw.alpha_for(b) for b in (4, 8, 16, 32)]


def test_screen_cells_shape_validation():
    _, tables = _spaces_and_tables()
    stacked = screen_jax.stack_cells(tables)
    with pytest.raises(ValueError, match=r"\(cells, n, 5\)"):
        screen.screen_cells(stacked, np.zeros((2, 7)), device="cpu")
    with pytest.raises(ValueError, match="stacked cells"):
        screen.screen_cells(stacked, np.zeros((1, 7, 5)), device="cpu")


def test_screen_cells_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, tables = _spaces_and_tables()
    with pytest.raises(RuntimeError, match="CUDA"):
        screen.screen_cells(screen_jax.stack_cells(tables), np.zeros((4, 3, 5)))


def test_prescreen_matches_searcher_rung0():
    """prescreen_cells_torch scores the exact block the hyperband searcher
    asks for: the same config construction, the same rng draws."""
    cells = expand_cells(["vgg16"], [(224, 224)], ["ku115"], [16, 8], [1])
    overrides = {"screen": 256, "survivors": 4}
    fits = prescreen_cells_torch(cells, base_seed=3, population=6, iterations=3,
                                 searcher_config=overrides, device="cpu")
    assert set(fits) == {c.key for c in cells}
    for c in cells:
        net = build_net(c.net, c.h, c.w)
        cfg = searcher_config_for(
            "hyperband", base=dict(population=6, iterations=3, patience=2,
                                   seed=cell_seed(3, c)),
            overrides=overrides)
        block = hyperband_rung0(SearchSpace(sp_max=len(net.major_layers),
                                            batch_max=c.batch_max), cfg)
        ref = screen_rav_batch(net, jax_hw.FPGAS[c.fpga], block, c.precision, c.precision)
        assert np.array_equal(fits[c.key], ref)


def test_campaign_torch_screen_record_parity(tmp_path):
    """A campaign whose cells take their rung-0 fitnesses from the port's
    screen gives the records of the NumPy-screened campaign, but for the
    search time (tests/test_jax_screen.py::test_campaign_jax_screen_record_parity)."""
    cells = expand_cells(["vgg16"], [(224, 224)], ["ku115", "zcu102"], [16], [1])
    kw = dict(searcher="hyperband", searcher_config={"screen": 256, "survivors": 4},
              population=6, iterations=3)
    plain = run_campaign(cells, str(tmp_path / "np.jsonl"), **kw)
    fits = prescreen_cells_torch(cells, population=6, iterations=3,
                                 searcher_config=kw["searcher_config"], device="cpu")
    screened = [run_cell(c, screen_fits=fits[c.key], **kw) for c in cells]
    assert len(plain.records) == len(screened) == len(cells)
    for a, b in zip(plain.records, screened):
        sa = {k: v for k, v in a.items() if k != "search_time_s"}
        sb = {k: v for k, v in b.items() if k != "search_time_s"}
        assert sa == sb
