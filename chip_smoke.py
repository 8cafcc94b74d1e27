#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch`` (nvcc, sm_90a)
and then runs three phases; any failure raises and exits non-zero.

  (A) The direct-conv kernel against its plain PyTorch version at every
      distinct conv shape of VGG-16 at 224x224, batch 8, in fp32 and bf16,
      and at the small shapes of the kernel tests (odd and even R).
      Tolerance atol = rtol = 2e-4 in fp32, 2e-2 in bf16. Per VGG shape it
      times the kernel, the plain version and one cuDNN ``F.conv2d`` call
      (the yardstick; the port never calls it) with CUDA events, and
      computes the least time the card could take (bytes over 3.35 TB/s or
      operations over the published peak of the dtype).
  (B) ``hybrid_forward`` on VGG-16 at 224x224, batch 8, HybridPlan(sp=4,
      n_micro=4), in fp32 and bf16, against ``forward(use_kernel=False)``:
      normalised error max|d| / max|ref| at most 2e-4 (fp32) and 2e-2
      (bf16), and exactly 13 conv kernel launches per forward.
  (C) The pipelined head at VGG width: 4 x conv(128, 3) as the head, then
      pool(2) and 2 x conv(256, 3), input (8, 128, 112, 112), against
      ``forward(use_kernel=False)`` at 2e-4.

Its last two lines are the kernel summary (one JSON object) and the result
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a CUDA
device it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.netinfo import _B, vgg16  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402
from repro_torch.models.cnn import (HybridPlan, forward, hybrid_forward,  # noqa: E402
                                    init_vgg)

# H100 SXM published peaks (dense): fp32 outside the tensor cores, bf16 on
# them, and HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py::_tol
DTYPES = (torch.float32, torch.bfloat16)
BATCH = 8
# (N, C, H, W, K, R) of tests/test_kernels.py::CONV_CASES, plus an even R.
SMALL_CASES = [(1, 16, 16, 16, 32, 3), (2, 3, 20, 24, 64, 5), (1, 8, 10, 10, 16, 1),
               (1, 64, 7, 9, 8, 7), (1, 12, 9, 11, 24, 4)]
REPLACES = "src/repro/kernels/conv2d/conv2d.py:40"
SOURCE = "src/repro_torch/kernels/conv2d/csrc/conv2d.cu"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err_within(out, ref, tol: float) -> float:
    """max |out - ref|; raises if any element misses atol + rtol * |ref|."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), "non-finite kernel output")
    check(bool((diff <= tol + tol * ref.abs()).all()),
          f"kernel disagrees with its plain version: max |diff| {diff.max().item():.3e}")
    return diff.max().item()


def bound(n, c, h, w, k, r, dtype) -> tuple[float, str]:
    """Least time in ms (bytes or operations) for one conv, and which bounds it."""
    elem = torch.finfo(dtype).bits // 8
    by = elem * (n * c * h * w + k * c * r * r + n * k * h * w)
    ops = 2 * n * k * c * h * w * r * r
    t_bytes, t_ops = by / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_inputs(n, c, h, w, k, r, dtype, gen):
    x = torch.randn((n, c, h, w), generator=gen, device="cuda").to(dtype)
    wt = torch.randn((k, c, r, r), generator=gen, device="cuda")
    return x, (wt * math.sqrt(2.0 / (c * r * r))).to(dtype)


def phase_a(gen) -> dict:
    """Kernel against plain version; per VGG shape, times and bounds."""
    for dtype in DTYPES:
        for n, c, h, w, k, r in SMALL_CASES:
            x, wt = conv_inputs(n, c, h, w, k, r, dtype, gen)
            err = max_err_within(conv2d(x, wt), conv2d_ref(x, wt), TOL[dtype])
            print(f"A {str(dtype)[6:]:8s} N={n} C={c} H={h} W={w} K={k} R=S={r}: "
                  f"max_abs_err {err:.3e}")

    convs = [l for l in vgg16(224).layers if l.kind == "conv"]
    shapes = sorted({(l.c, l.k, l.h) for l in convs}, key=lambda s: (-s[2], s[0], s[1]))
    check(len(shapes) == 9, f"expected 9 distinct VGG-16 conv shapes, got {len(shapes)}")
    summary = {}
    for dtype in DTYPES:
        rows = []
        for c, k, h in shapes:
            x, wt = conv_inputs(BATCH, c, h, h, k, 3, dtype, gen)
            err = max_err_within(conv2d(x, wt), conv2d_ref(x, wt), TOL[dtype])
            b_ms, b_by = bound(BATCH, c, h, h, k, 3, dtype)
            row = dict(c=c, k=k, h=h, max_abs_err=err,
                       ms=time_ms(lambda: conv2d(x, wt)),
                       plain_ms=time_ms(lambda: conv2d_ref(x, wt)),
                       library_ms=time_ms(lambda: F.conv2d(x, wt, padding=1)),
                       bound_ms=b_ms, bound_by=b_by,
                       layers=sum((l.c, l.k, l.h) == (c, k, h) for l in convs))
            rows.append(row)
            print(f"A {str(dtype)[6:]:8s} VGG N={BATCH} C={c:3d} K={k:3d} H=W={h:3d} "
                  f"x{row['layers']}: max_abs_err {err:.3e}  kernel {row['ms']:.4f} ms  "
                  f"bound {b_ms:.4f} ms ({b_by})  plain {row['plain_ms']:.4f} ms  "
                  f"cuDNN {row['library_ms']:.4f} ms")
            del x, wt
        summary[dtype] = rows
    return summary


def vgg_forward_summary(rows) -> dict:
    """Per-layer numbers summed over the 13 convs of one VGG-16 forward."""
    tot = {key: sum(r[key] * r["layers"] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    ops_ms = sum(r["bound_ms"] * r["layers"] for r in rows if r["bound_by"] == "operations")
    tot["bound_by"] = "operations" if ops_ms >= tot["bound_ms"] / 2 else "bytes"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return tot


def phase_b(gen) -> dict:
    """Full-width VGG-16 hybrid forward; returns launches per forward by dtype."""
    net = vgg16(224)
    plan = HybridPlan(sp=4, n_micro=4)
    launches = {}
    for dtype in DTYPES:
        params = init_vgg(net, generator=gen, device="cuda", dtype=dtype)
        x = torch.randn((BATCH, 3, 224, 224), generator=gen, device="cuda").to(dtype)
        hybrid_forward(params, net, x, plan)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            conv2d.launches = 0
            t0 = time.perf_counter()
            out = hybrid_forward(params, net, x, plan)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            check(conv2d.launches == 13,
                  f"{conv2d.launches} conv2d launches in one forward, expected 13")
        launches[dtype] = conv2d.launches
        ref = forward(params, net, x, use_kernel=False)
        check(tuple(out.shape) == (BATCH, 512, 7, 7), f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite forward output")
        err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        check(err <= TOL[dtype], f"hybrid forward vs plain: normalised error {err:.3e}")
        wall = statistics.median(walls)
        print(f"B {str(dtype)[6:]:8s} VGG-16 224x224 N={BATCH} hybrid sp=4 n_micro=4: "
              f"normalised error {err:.3e}  launches {launches[dtype]}  "
              f"wall {wall:.3f} ms (median of {len(walls)})  {BATCH / wall * 1e3:.1f} images/s")
        del params, x, out, ref
    return launches


def phase_c(gen) -> None:
    """Pipelined head at the width of VGG-16's second group."""
    b = _B("vgg_group2", 112, 112, 128)
    for _ in range(4):
        b.conv(128, 3)
    b.pool(2)
    b.conv(256, 3).conv(256, 3)
    net = b.done()
    plan = HybridPlan(sp=4, n_micro=4)
    params = init_vgg(net, generator=gen, device="cuda")
    x = torch.randn((BATCH, 128, 112, 112), generator=gen, device="cuda")
    conv2d.launches = 0
    out = hybrid_forward(params, net, x, plan, pipelined=True)
    torch.cuda.synchronize()
    # every stage runs at each of n_micro + n_stages - 1 ticks, plus the tail
    expected = 4 * (plan.n_micro + 4 - 1) + 2
    check(conv2d.launches == expected,
          f"{conv2d.launches} conv2d launches in the pipelined run, expected {expected}")
    ref = forward(params, net, x, use_kernel=False)
    check(tuple(out.shape) == (BATCH, 256, 56, 56), f"output shape {tuple(out.shape)}")
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    check(err <= TOL[torch.float32], f"pipelined head vs plain: normalised error {err:.3e}")
    print(f"C float32  group net (8,128,112,112) pipelined sp=4 n_micro=4: "
          f"normalised error {err:.3e}  launches {conv2d.launches}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"setup: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(libs):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"setup: {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_a(gen)
    launches = phase_b(gen)
    phase_c(gen)

    entry = {"name": "conv2d", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
             "dtype": "float32", "launches": launches[torch.float32],
             **vgg_forward_summary(rows[torch.float32]),
             "bfloat16": {"launches": launches[torch.bfloat16],
                          **vgg_forward_summary(rows[torch.bfloat16])}}
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
