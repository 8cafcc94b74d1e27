"""Cells cut to a size the CPU runs in seconds, for the tests: the
configuration's reduced architecture (with the file's RoPE base and window)
and a small traffic of the same kind."""
from __future__ import annotations

import dataclasses

from portbench.harness import spec


def small_cell(name: str) -> spec.Cell:
    from repro_torch.configs import get_config
    c = spec.cell(name)
    arch = dataclasses.asdict(get_config(c.config["arch"]["name"]).reduced())
    arch.pop("ssm")
    arch.update({k: c.config["arch"][k] for k in ("rope_theta", "window")})
    tr = dict(c.traffic)
    if tr["driver"] == "prefill_batches":
        tr.update(seq_lens=[32, 64], tokens_per_batch=128, pool=2, trace_steps=2, judge=[4, 2])
    else:
        tr.update(slots=4, clients=4, max_seq=128, prompt=[4, 16], output=[8, 32], max_total=40,
                  stream=300, warmup_ticks=20, trace_steps=3, judge=1000)
    return dataclasses.replace(c, config=dict(c.config, arch=arch), traffic=tr)
