"""Screen every campaign cell's hyperband rung 0 in one call of the port.

The counterpart of ``repro/dse/campaign.py::prescreen_cells_jax``, outside
both packages because it joins them: the tables and the rung-0 blocks come
from the JAX package's NumPy code (``screen_jax.cell_tables``,
``search.hyperband_rung0``), the screen from the port
(``repro_torch.core.screen.screen_cells``). The result is
``{cell.key: (screen,) fitness array}`` for ``campaign.run_cell(...,
screen_fits=)``:

    from tools.torch_prescreen import prescreen_cells_torch
    fits = prescreen_cells_torch(cells, searcher_config={"screen": 256}, device="cuda")
    records = [run_cell(c, searcher="hyperband", screen_fits=fits[c.key], ...) for c in cells]
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from repro.core import screen_jax
from repro.core.hw_specs import FPGAS
from repro.core.pso import PSOConfig
from repro.core.search import SearchSpace, hyperband_rung0, searcher_config_for
from repro.dse.campaign import CampaignCell, build_net, cell_seed
from repro_torch.core import screen


def prescreen_cells_torch(cells: Sequence[CampaignCell], *, base_seed: int = 0,
                          population: int = 20, iterations: int = 30,
                          searcher_config: Mapping | None = None, calibration=None,
                          device="cuda") -> dict:
    """``prescreen_cells_jax`` with the port's screen: the same rung-0 blocks
    (the searcher's own config construction and rng draws), the same
    tables, one ``screen.screen_cells`` call over every cell."""
    tables, blocks, keys = [], [], []
    for cell in cells:
        net = build_net(cell.net, cell.h, cell.w)
        fpga = FPGAS[cell.fpga]
        if calibration is not None:
            fpga = calibration.for_spec(fpga)
        pso = PSOConfig(population=population, iterations=iterations,
                        seed=cell_seed(base_seed, cell))
        cfg = searcher_config_for(
            "hyperband",
            base=dict(population=pso.population, iterations=pso.iterations,
                      patience=pso.patience, seed=pso.seed),
            overrides=searcher_config)
        space = SearchSpace(sp_max=len(net.major_layers), batch_max=cell.batch_max)
        blocks.append(hyperband_rung0(space, cfg))
        tables.append(screen_jax.cell_tables(net, fpga, cell.precision, cell.precision))
        keys.append(cell.key)
    if not keys:
        return {}
    ips = screen.screen_cells(screen_jax.stack_cells(tables), np.stack(blocks), device=device)
    return {k: ips[i] for i, k in enumerate(keys)}
