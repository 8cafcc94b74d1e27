#!/usr/bin/env python3
"""Time and check the fp32 tf32x3 routes of the matmul and the conv.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/tf32x3_probe.py

It builds the kernels, prints the card's name and power limit and the
ptxas spill lines of the tf32x3 kernels, then, at StarCoder2-3B's fp32
product shapes at prefill (M = 4 x 512) and at the fp32 VGG-16 convs at
224 x 224, batch 8, compares the route's result with a float64 product
(normalised error max|d| / max|ref|, beside torch.matmul's for the
products) and times back to back, as ``chip_smoke.py`` does (``b2b_ms``:
calls between one pair of CUDA events, L2 flushed): the route, its split
pass alone, the PyTorch call (``torch.matmul`` / ``F.conv2d``, TF32 off)
and the CUDA-core route it replaced (``simt`` / ``direct``), and gives the
split-TF32 bound (three TF32 products at 495 TFLOP/s) and the route's
share of it.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d import conv2d as conv_launcher  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.kernels.matmul import matmul as mm_launcher  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402

ROWS = 2048  # StarCoder2-3B's prefill, 4 x 512 tokens
PRODUCTS = [(3072, 3072), (3072, 12288), (12288, 3072), (3072, 256), (3072, 49152)]  # (K, N)
CONVS = [(64, 64, 224), (64, 128, 112), (128, 128, 112), (128, 256, 56), (256, 256, 56),
         (256, 512, 28), (512, 512, 28), (512, 512, 14)]  # (C, K, H) at batch 8
OLD_ROUTE_REPS = 5  # the CUDA-core routes are slow: fewer calls between the events


def normalised(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.double() - ref).abs().max() / ref.abs().max()).item()


def split_bound_ms(ops: float) -> float:
    return chip_smoke.TF32_PRODUCTS * ops / chip_smoke.TF32_FLOPS * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32x3_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    for name in ("matmul", "conv2d"):
        lines = _build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            if "tf32x3" in line and "entry function" in line:
                after = [l.strip() for l in lines[i + 1:i + 4] if "spill" in l or "registers" in l]
                print(f"{name}: {line.split()[-3]} " + "; ".join(after))
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k, n in PRODUCTS:
        a = torch.randn((ROWS, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        p = mm_launcher.plan_for(a, b)
        ref = a.double() @ b.double()
        err, lib_err = normalised(matmul(a, b), ref), normalised(torch.matmul(a, b), ref)
        simt = mm_launcher.Plan("simt", "128x128", mm_launcher._splits(
            ROWS, n, k, mm_launcher.TILES["simt", "128x128"], mm_launcher.sm_count(0)))
        out = torch.empty((ROWS, n), device="cuda")
        t = chip_smoke.b2b_ms(lambda i: matmul(a, b))
        t_old = chip_smoke.b2b_ms(lambda i: mm_launcher.launch(a, b, out, simt, stream),
                                  OLD_ROUTE_REPS)
        bound = split_bound_ms(2 * ROWS * k * n)
        print(f"matmul M={ROWS} K={k} N={n} {p.route} splits {p.splits}: normalised error "
              f"{err:.3e} (torch.matmul {lib_err:.3e}); back to back {t:.4f} ms, split pass "
              f"{chip_smoke.b2b_ms(lambda i: mm_launcher.split(a, b)):.4f} ms, torch.matmul "
              f"{chip_smoke.b2b_ms(lambda i: torch.matmul(a, b)):.4f} ms, simt {t_old:.4f} ms; "
              f"split-TF32 bound {bound:.4f} ms, {bound / t:.1%} of it")
        del a, b, ref, out
    for c, k, h in CONVS:
        x = torch.randn((chip_smoke.BATCH, c, h, h), generator=gen, device="cuda")
        w = torch.randn((k, c, 3, 3), generator=gen, device="cuda") * (2 / (9 * c)) ** 0.5
        p = conv_launcher.plan_for(x, w)
        err = normalised(conv2d(x, w), F.conv2d(x.double(), w.double(), padding=1))
        out = torch.empty((chip_smoke.BATCH, k, h, h), device="cuda")
        direct = conv_launcher.Plan("direct", (), 1, 1, 0)
        t = chip_smoke.b2b_ms(lambda i: conv2d(x, w))
        t_old = chip_smoke.b2b_ms(lambda i: conv_launcher.launch(x, w, out, direct),
                                  OLD_ROUTE_REPS)
        bound = split_bound_ms(2 * chip_smoke.BATCH * k * c * h * h * 9)
        print(f"conv2d N={chip_smoke.BATCH} C={c} K={k} H=W={h} {chip_smoke.plan_text(p)}: "
              f"normalised error {err:.3e}; back to back {t:.4f} ms, split re-layout "
              f"{chip_smoke.b2b_ms(lambda i: conv_launcher.split(x, w)):.4f} ms, cuDNN "
              f"{chip_smoke.b2b_ms(lambda i: F.conv2d(x, w, padding=1)):.4f} ms, direct "
              f"{t_old:.4f} ms; split-TF32 bound {bound:.4f} ms, {bound / t:.1%} of it")
        del x, w, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
