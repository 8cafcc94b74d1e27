#!/usr/bin/env python3
"""Time the conv's wgmma route under other plans at every bf16 VGG-16 shape.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/conv_sweep.py

For every distinct conv shape of VGG-16 at 224x224, batch 8, that the wgmma
route takes, it tries a grid of plans: every box that covers the image in
the fewest tiles, 1 or 2 blocks per SM, tiles of 128 output channels (and
of 64 where K <= 64), and, where one wave of tiles leaves SMs idle, 1 to 4
splits. It checks each against ``conv2d_ref`` and times it
back to back as ``chip_smoke.py`` does (``b2b_ms``: 50 calls between one
pair of CUDA events, L2 flushed), the variants in order, then cuDNN
(``F.conv2d``), then the variants in reverse; each keeps the lower of its
two times. It also times the route's re-layout kernel alone. It prints the
per-shape times beside the plan that ``conv2d.plan`` picks, and the sums
over one forward of the plan's choices, of the best variant of each shape
and of cuDNN.
"""
from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.core.netinfo import vgg16  # noqa: E402
from repro_torch.kernels.conv2d import conv2d as launcher  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402


def variants(n, c, h, k, sms) -> list:
    """The plans tried at one shape."""
    tiles = {b: launcher._ceil_div(h, b[1]) * launcher._ceil_div(h, b[0])
             for b in launcher.BOXES}
    boxes = [b for b in launcher.BOXES if tiles[b] == min(tiles.values())]
    tiles_n = [tn for tn in launcher.TILES_N if tn == 128 or k <= tn]
    out = []
    for box, blocks, tile_n in itertools.product(boxes, launcher.BLOCKS_PER_SM, tiles_n):
        n_tiles = n * tiles[box] * launcher._ceil_div(k, tile_n)
        splits = range(1, 5) if n_tiles < sms * blocks else (1,)
        out += [launcher.Plan("wgmma", box, s, blocks, tile_n) for s in splits]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=chip_smoke.BATCH)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sms = launcher.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    convs = [l for l in vgg16(224).layers if l.kind == "conv" and l.c % launcher.BK == 0]
    shapes = sorted({(l.c, l.k, l.h) for l in convs}, key=lambda s: (-s[2], s[0], s[1]))
    tot = {"plan": 0.0, "best": 0.0, "cuDNN": 0.0, "relayout": 0.0}
    for c, k, h in shapes:
        layers = sum((l.c, l.k, l.h) == (c, k, h) for l in convs)
        x, wt = chip_smoke.conv_inputs(args.batch, c, h, h, k, 3, torch.bfloat16, gen)
        ref = conv2d_ref(x, wt)
        vs = variants(args.batch, c, h, k, sms)
        out = torch.empty_like(ref)
        for p in vs:
            out.fill_(float("nan"))
            launcher.launch(x, wt, out, p)
            chip_smoke.max_err_within(out, ref, chip_smoke.TOL[torch.bfloat16])

        def timed(p):
            return chip_smoke.b2b_ms(lambda i: launcher.launch(x, wt, out, p))

        first = {p: timed(p) for p in vs}
        cudnn = chip_smoke.b2b_ms(lambda i: F.conv2d(x, wt, padding=1))
        ms = {p: min(first[p], timed(p)) for p in reversed(vs)}
        relayout = chip_smoke.b2b_ms(lambda i: launcher.relayout(x, wt))
        chosen = launcher.plan(args.batch, c, h, h, k, 3, 3, torch.bfloat16, sms)
        if chosen not in ms:
            ms[chosen] = timed(chosen)
        best = min(ms, key=ms.get)
        b_ms, _ = chip_smoke.bound(args.batch, c, h, h, k, 3, torch.bfloat16)
        print(f"C={c:3d} K={k:3d} H=W={h:3d} x{layers}: cuDNN {cudnn:.4f} ms  re-layout "
              f"{relayout:.4f} ms  bound {b_ms:.4f} ms  plan {chip_smoke.plan_text(chosen)} "
              f"{ms[chosen]:.4f} ms")
        for p in vs:
            print(f"    {chip_smoke.plan_text(p)}: {ms[p]:.4f} ms"
                  + ("  best" if p == best else ""))
        tot["plan"] += layers * ms[chosen]
        tot["best"] += layers * ms[best]
        tot["cuDNN"] += layers * cudnn
        tot["relayout"] += layers * relayout
        del x, wt, ref, out
    print("sums over the 12 wgmma convs of one forward, back to back: "
          + "  ".join(f"{key} {v:.4f} ms" for key, v in tot.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
