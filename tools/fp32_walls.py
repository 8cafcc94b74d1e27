#!/usr/bin/env python3
"""Time the fp32 paths that run the matmul at M <= 64 and fp32 flash attention.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/fp32_walls.py [--tree PATH]

``--tree`` puts ``PATH/src`` first on the path (default: this checkout), so
that one call can time two trees in turn (each builds its kernels into its
own ``build/``). On the kernel route, in fp32 compute, weights drawn in bf16
from a seeded generator and cast to fp32, it prints the card's name and
power limit, then for each path the median wall (host clock to a device
sync) and the launches by route of one call:

- Zamba2-2.7B ``prefill_logits`` at 4 x 512 (``chip_smoke.py`` phase H's
  model): 9 flash attention calls at hd 80;
- StarCoder2-3B ``decode_step`` on a 4-slot cache (phase F's model): 181
  products at M = 4;
- xLSTM-350M ``prefill_logits`` at 4 x 512 (phase N): 2,048 recurrent
  products at M = 4;
- Whisper-base ``encode`` of 4 x 1500 frames, ``decode_train`` over 4 x 448
  tokens, and one ``decode_step`` (phase O; the mean of 448 steps);

then the host microseconds of one fp32 matmul wrapper call at the tick's
(4, 3072) @ (3072, 3072), on the route its plan picks and with B's
storage 4 bytes off a 16-byte boundary (simt), beside ``torch.matmul``'s.
The walls of these paths follow the host, which varies from call to call:
compare two trees only within one call, in turns. The last line is one
JSON object with every wall, launch count and host time.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, SLOTS, MAX_SEQ = 4, 512, 4, 256
WHISPER_BATCH, WHISPER_TOKENS = 4, 448
SEED = 26


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("fp32_walls: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import tree as ptree
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.matmul.matmul import plan_for
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.models import api, encdec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = torch.float32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"tree {args.tree}; card: {card.strip()}")

    def timed(fn, reps: int):
        """(median wall ms of reps calls after one warm-up, launches by route of one call)"""
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            matmul.launches_by_route = dict.fromkeys(matmul.launches_by_route, 0)
            flash_attention.launches_by_route = dict.fromkeys(
                flash_attention.launches_by_route, 0)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls), {"matmul": dict(matmul.launches_by_route),
                                          "flash_attention": dict(
                                              flash_attention.launches_by_route)}

    def model(arch: str):
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = api.init_params(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
        return cfg, ptree.map_tree(lambda t: t.to(fp32), params), gen

    out = {}

    def report(name: str, wall: float, routes: dict) -> None:
        out[name] = {"wall_ms": wall, **routes}
        print(f"{name}: {wall:.3f} ms  launches {routes}")

    with torch.inference_mode():
        cfg, p, gen = model("zamba2-2.7b")
        tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=gen, device="cuda")
        report("zamba2-2.7b fp32 prefill", *timed(
            lambda: api.prefill_logits(p, cfg, {"tokens": tokens}, compute_dtype=fp32), 3))
        del p

        cfg, p, gen = model("starcoder2-3b")
        cache = api.init_cache(cfg, SLOTS, MAX_SEQ, fp32, device="cuda")
        toks = torch.randint(0, cfg.vocab, (SLOTS, 1), generator=gen, device="cuda")
        pos = torch.arange(SLOTS, device="cuda") * 7
        report("starcoder2-3b fp32 decode_step", *timed(
            lambda: api.decode_step(p, cfg, cache, toks, pos, compute_dtype=fp32), 20))
        del p, cache

        cfg, p, gen = model("xlstm-350m")
        tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=gen, device="cuda")
        report("xlstm-350m fp32 prefill", *timed(
            lambda: api.prefill_logits(p, cfg, {"tokens": tokens}, compute_dtype=fp32), 3))
        del p

        cfg, p, gen = model("whisper-base")
        frames = torch.randn((WHISPER_BATCH, cfg.n_audio_frames, cfg.d_model), generator=gen,
                             device="cuda")
        tokens = torch.randint(0, cfg.vocab, (WHISPER_BATCH, WHISPER_TOKENS), generator=gen,
                               device="cuda")
        mem = encdec.encode(p, cfg, frames, compute_dtype=fp32)
        report("whisper-base fp32 encode", *timed(
            lambda: encdec.encode(p, cfg, frames, compute_dtype=fp32), 3))
        report("whisper-base fp32 decode_train", *timed(
            lambda: encdec.decode_train(p, cfg, tokens, mem, compute_dtype=fp32), 3))
        cache = encdec.prefill_cross(p, cfg, mem, api.init_cache(
            cfg, WHISPER_BATCH, WHISPER_TOKENS, fp32, device="cuda"))

        def steps(cache=cache):
            for t in range(WHISPER_TOKENS):
                _, cache = api.decode_step(p, cfg, cache, tokens[:, t:t + 1],
                                           torch.full((WHISPER_BATCH,), t, device="cuda"),
                                           compute_dtype=fp32)

        wall, routes = timed(steps, 1)
        per = {k: {r: n // WHISPER_TOKENS for r, n in v.items()} for k, v in routes.items()}
        report("whisper-base fp32 decode_step", wall / WHISPER_TOKENS, per)
        del p, cache, mem

        def host_us(fn, calls: int = 200) -> float:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            us = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
            return us

        a = torch.randn((SLOTS, 3072), generator=gen, device="cuda")
        b = torch.randn((3072, 3072), generator=gen, device="cuda")
        off = torch.empty(b.numel() + 1, device="cuda")[1:].view(b.shape)
        off.copy_(b)
        host = {f"wrapper {plan_for(a, b).route}": host_us(lambda: matmul(a, b)),
                f"wrapper {plan_for(a, off).route} (B off 16 bytes)":
                    host_us(lambda: matmul(a, off)),
                "torch.matmul": host_us(lambda: torch.matmul(a, b))}
        print("host us a call, fp32 matmul (4, 3072) @ (3072, 3072): "
              + "  ".join(f"{k} {v:.1f}" for k, v in host.items()))
    print(json.dumps({"tree": args.tree, "card": card.strip(), "walls": out, "host_us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
