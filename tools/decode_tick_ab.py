#!/usr/bin/env python3
"""Time StarCoder2-3B's bf16 decode tick under two or more source trees,
alternating, on one card.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/decode_tick_ab.py TREE_A TREE_B [--order 0,1,1,0,0,1,1,0]

Each entry of ``--order`` starts one process with ``TREE/src`` first on the
path (each tree builds its kernels into its own ``build/``), which draws
StarCoder2-3B at full width and depth in bf16 from seed 0 and then:

- serves the 8 requests of ``chip_smoke.py``'s phase F on 4 slots through
  ``ContinuousBatcher`` (kernel route) and times every tick (the tick's
  argmax reaches the host, so a tick ends on the device);
- calls ``api.decode_step`` ``--calls`` times on one cache: the host ms
  until the call returns and the wall ms to the end of its device work;
- times ``transformer.layer(params["blocks"], i)``, the walk over one
  block's parameters that every layer of a tick makes, in host µs a call;
- profiles 5 more ``decode_step`` calls with ``cProfile`` and keeps the 12
  functions of most self time (host ms a step).

Each process prints one JSON line; the tool prints them with the card's
name and power limit, then the medians by tree.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path


def worker(tree: str, calls: int) -> dict:
    sys.path.insert(0, str(Path(tree, "src")))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import api, transformer
    from repro_torch.serve.scheduler import ContinuousBatcher, Request

    _build.build_all()
    cfg = get_config("starcoder2-3b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = transformer.init_lm(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab,
                                                                 int(rng.integers(16, 65)))],
                    max_new=int(rng.integers(8, 17))) for i in range(8)]
    b = ContinuousBatcher(cfg, params, slots=4, max_seq=256, device="cuda")
    for r in reqs:
        b.submit(r)
    ticks = []
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not b.step():
            break
        ticks.append((time.perf_counter() - t0) * 1e3)

    cache = api.init_cache(cfg, 4, 256, device="cuda")
    toks = torch.zeros((4, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((4,), 7, device="cuda")
    host, wall = [], []
    with torch.inference_mode():
        for _ in range(calls + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.decode_step(params, cfg, cache, toks, pos)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            wall.append((t2 - t0) * 1e3)
    host, wall = host[2:], wall[2:]
    prof = cProfile.Profile()
    with torch.inference_mode():
        prof.enable()
        for _ in range(5):
            api.decode_step(params, cfg, cache, toks, pos)
        prof.disable()
        torch.cuda.synchronize()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:12]
    top = [f"{func[2]} ({Path(func[0]).name}:{func[1]}) {st[1]} calls {st[2] / 5 * 1e3:.3f} ms a "
           f"step (self), {st[3] / 5 * 1e3:.3f} ms (cumulative)" for func, st in rows]
    n = 2000
    t0 = time.perf_counter()
    for j in range(n):
        transformer.layer(params["blocks"], j % cfg.n_layers)
    layer_us = (time.perf_counter() - t0) * 1e6 / n
    return {"tree": tree, "ticks": len(ticks), "tick_ms_median": statistics.median(ticks),
            "tick_ms_mean": statistics.mean(ticks), "decode_step_host_ms": statistics.median(host),
            "decode_step_wall_ms": statistics.median(wall), "layer_walk_us": layer_us,
            "layer_walk_ms_a_tick": layer_us * cfg.n_layers / 1e3,
            "host_profile_by_self_time": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--order", default="0,1,1,0,0,1,1,0")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.calls)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = []
    for i in (int(x) for x in args.order.split(",")):
        tree = str(Path(args.trees[i]).resolve())
        out = subprocess.run([sys.executable, __file__, "--worker", tree, "--calls",
                              str(args.calls)], capture_output=True, text=True, env=env,
                             cwd=tree)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    for tree in dict.fromkeys(r["tree"] for r in runs):
        mine = [r for r in runs if r["tree"] == tree]
        print(tree, {k: [round(r[k], 4) for r in mine] for k in
                     ("tick_ms_median", "decode_step_host_ms", "decode_step_wall_ms",
                      "layer_walk_us")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
