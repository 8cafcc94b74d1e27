#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch`` (nvcc, sm_90a,
one process per source, all started together) and then runs six phases;
any failure raises and exits non-zero.

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
  (D) The matmul, RMSNorm and flash-attention kernels against their plain
      versions, fp32 and bf16, at every shape StarCoder2-3B's serving path
      gives them (prefill at batch 4 x 512 tokens, decode at 4 slots) and
      at the small shapes of the kernel tests (the window case, head dim
      48, queries shorter than keys, M = 1). Tolerance atol = rtol = 2e-4
      in fp32, 2e-2 in bf16. Per full-width shape it times the kernel, the
      plain version and one PyTorch call of the same function
      (``torch.matmul``, ``F.rms_norm``, ``F.scaled_dot_product_attention``;
      the yardstick, never called by the port) and computes the bound.
  (E) Prefill: ``api.prefill_logits`` on StarCoder2-3B at full width and
      depth, bf16 weights from a seeded generator, batch 4 x 512 tokens,
      against ``forward(use_kernel=False)``: normalised error at most
      2e-2, finite (4, 512, 49152) logits, and exactly 181 matmul, 61
      RMSNorm and 30 flash-attention launches per forward.
  (F) Serving: ``ContinuousBatcher`` on the same weights, 4 slots, 8 seeded
      requests (prompts of 16-64 tokens, 8-16 new tokens each): every
      request completes; every tick makes exactly 181 matmul and 61
      RMSNorm launches; on the first 4 ticks the kernel decode step agrees
      with the plain one on the same cache (logits and new caches within
      2e-2 normalised); ``steps`` and ``utilization`` equal a plain-route
      batcher's on the same requests.

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

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.netinfo import _B, vgg16  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models.cnn import (HybridPlan, forward, hybrid_forward,  # noqa: E402
                                    init_vgg)
from repro_torch.serve.scheduler import ContinuousBatcher, Request  # noqa: E402

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


def least_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound(n, c, h, w, k, r, dtype) -> tuple[float, str]:
    """Least time in ms (bytes or operations) for one conv, and which bounds it."""
    elem = torch.finfo(dtype).bits // 8
    by = elem * (n * c * h * w + k * c * r * r + n * k * h * w)
    return least_ms(by, 2 * n * k * c * h * w * r * r, dtype)


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


# ---------------------------------------------------------------------------
# The dense LM: StarCoder2-3B serving (phases D-F)
# ---------------------------------------------------------------------------

LM_ARCH = "starcoder2-3b"
PREFILL_BATCH, PREFILL_SEQ = 4, 512
SLOTS, MAX_SEQ, N_REQUESTS = 4, 256, 8
LM_KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "matmul": ("src/repro_torch/kernels/matmul/csrc/matmul.cu",
               "src/repro/kernels/matmul/matmul.py:36"),
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/rmsnorm.py:25"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:82"),
}
WRAPPERS = {"matmul": matmul, "rmsnorm": rmsnorm, "flash_attention": flash_attention}
# Small shapes of the kernel tests: tests/test_kernels.py::MM_CASES (M, K, N)
# plus single rows; tests/test_serving.py's RMSNorm shapes; ATTN_CASES
# (b, s, h, kv, hd, causal, window) and queries shorter than keys
# (b, s, s_k, h, kv, hd, window).
MM_SMALL = [(256, 512, 256), (100, 300, 50), (64, 64, 64), (128, 1, 128), (33, 65, 17),
            (1, 200, 129), (1, 3072, 3072)]
RMS_SMALL = [(2, 16, 64), (1, 100, 128), (4, 7, 48)]
ATTN_SMALL = [(1, 128, 4, 2, 64, True, None), (2, 96, 4, 4, 32, True, None),
              (1, 256, 8, 2, 64, True, 64), (1, 64, 2, 2, 64, False, None),
              (1, 128, 6, 2, 48, True, None)]
ATTN_SHORT_Q = [(2, 40, 100, 4, 2, 32, None), (1, 70, 200, 6, 2, 48, 64)]


def normalised_err(out, ref) -> float:
    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), "non-finite output")
    return ((out - ref).abs().max() / ref.abs().max()).item()


def name_of(dtype) -> str:
    return str(dtype)[6:]


def lm_products(cfg) -> dict:
    """(K, N) -> how many products of that shape one forward (or decode step) makes."""
    hd = cfg.head_dim
    per_layer = [(cfg.d_model, cfg.n_heads * hd), (cfg.d_model, cfg.n_kv * hd),
                 (cfg.d_model, cfg.n_kv * hd), (cfg.n_heads * hd, cfg.d_model),
                 (cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)]
    if cfg.gated_mlp:
        per_layer.append((cfg.d_model, cfg.d_ff))
    counts: dict = {}
    for kn in per_layer:
        counts[kn] = counts.get(kn, 0) + cfg.n_layers
    head = (cfg.d_model, cfg.vocab)
    counts[head] = counts.get(head, 0) + 1
    return counts


def expected_launches(cfg, decode: bool = False) -> dict:
    return {"matmul": sum(lm_products(cfg).values()), "rmsnorm": 2 * cfg.n_layers + 1,
            "flash_attention": 0 if decode else cfg.n_layers}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def randn(shape, dtype, gen, scale: float = 1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def timed_row(kernel, plain, library, nbytes, ops, dtype, **shape) -> dict:
    """Kernel against its plain version on the same inputs, and the three times."""
    tol = TOL[dtype]
    err = max_err_within(kernel(), plain(), tol)
    b_ms, b_by = least_ms(nbytes, ops, dtype)
    return dict(shape, max_abs_err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def print_row(tag: str, dtype, desc: str, row: dict) -> None:
    print(f"D {name_of(dtype):8s} {tag:15s} {desc}: max_abs_err {row['max_abs_err']:.3e}  "
          f"kernel {row['ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})  "
          f"plain {row['plain_ms']:.4f} ms  library {row['library_ms']:.4f} ms  "
          f"x{row['count']} per {row['per']}")


def phase_d(gen) -> dict:
    """LM kernels against their plain versions; per full-width shape, times and bounds.

    Returns {kernel: {dtype: [rows]}}, each row with its count per prefill
    forward or per decode tick ("per").
    """
    for dtype in DTYPES:
        for m, k, n in MM_SMALL:
            a, b = randn((m, k), dtype, gen), randn((k, n), dtype, gen, k ** -0.5)
            err = max_err_within(matmul(a, b), matmul_ref(a, b), TOL[dtype])
            print(f"D {name_of(dtype):8s} matmul M={m} K={k} N={n}: max_abs_err {err:.3e}")
        for shape in RMS_SMALL:
            x, sc = randn(shape, dtype, gen), randn(shape[-1:], dtype, gen)
            err = max_err_within(rmsnorm(x, sc), rmsnorm_ref(x, sc), TOL[dtype])
            print(f"D {name_of(dtype):8s} rmsnorm {shape}: max_abs_err {err:.3e}")
        cases = [(b, s, s, h, kv, hd, c, w) for b, s, h, kv, hd, c, w in ATTN_SMALL]
        cases += [(b, s, sk, h, kv, hd, True, w) for b, s, sk, h, kv, hd, w in ATTN_SHORT_Q]
        for b, s, sk, h, kv, hd, causal, win in cases:
            q = randn((b, s, h, hd), dtype, gen)
            k, v = randn((b, sk, kv, hd), dtype, gen), randn((b, sk, kv, hd), dtype, gen)
            err = max_err_within(flash_attention(q, k, v, causal=causal, window=win),
                                 attention_ref(q, k, v, causal=causal, window=win), TOL[dtype])
            print(f"D {name_of(dtype):8s} flash B={b} S={s} Sk={sk} H={h} KV={kv} hd={hd} "
                  f"causal={causal} window={win}: max_abs_err {err:.3e}")

    cfg = get_config(LM_ARCH)
    rows_m = PREFILL_BATCH * PREFILL_SEQ
    out = {name: {} for name in LM_KERNELS}
    for dtype in DTYPES:
        el = torch.finfo(dtype).bits // 8
        mm_rows = []
        for per, m in (("prefill", rows_m), ("decode tick", SLOTS)):
            for (k, n), count in lm_products(cfg).items():
                a, b = randn((m, k), dtype, gen), randn((k, n), dtype, gen, k ** -0.5)
                row = timed_row(lambda: matmul(a, b), lambda: matmul_ref(a, b),
                                lambda: torch.matmul(a, b), el * (m * k + k * n + m * n),
                                2 * m * k * n, dtype, m=m, k=k, n=n, count=count, per=per)
                print_row("matmul", dtype, f"M={m} K={k} N={n}", row)
                mm_rows.append(row)
                del a, b
        rms_rows = []
        for per, m in (("prefill", rows_m), ("decode tick", SLOTS)):
            x, sc = randn((m, cfg.d_model), dtype, gen), randn((cfg.d_model,), dtype, gen)
            row = timed_row(lambda: rmsnorm(x, sc), lambda: rmsnorm_ref(x, sc),
                            lambda: F.rms_norm(x, (cfg.d_model,), sc, 1e-6),
                            el * (2 * m * cfg.d_model + cfg.d_model), 4 * m * cfg.d_model, dtype,
                            m=m, d=cfg.d_model, count=2 * cfg.n_layers + 1, per=per)
            print_row("rmsnorm", dtype, f"rows={m} D={cfg.d_model}", row)
            rms_rows.append(row)
        b, s, h, kv, hd = PREFILL_BATCH, PREFILL_SEQ, cfg.n_heads, cfg.n_kv, cfg.head_dim
        q = randn((b, s, h, hd), dtype, gen)
        k, v = randn((b, s, kv, hd), dtype, gen), randn((b, s, kv, hd), dtype, gen)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = timed_row(lambda: flash_attention(q, k, v, causal=True),
                        lambda: attention_ref(q, k, v, causal=True),
                        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                               enable_gqa=True),
                        el * (2 * q.numel() + k.numel() + v.numel()),
                        4 * b * h * s * s * hd / 2, dtype,
                        b=b, s=s, sk=s, h=h, kv=kv, hd=hd, count=cfg.n_layers, per="prefill")
        print_row("flash_attention", dtype, f"B={b} S=Sk={s} H={h} KV={kv} hd={hd} causal", row)
        out["matmul"][dtype], out["rmsnorm"][dtype] = mm_rows, rms_rows
        out["flash_attention"][dtype] = [row]
        del q, k, v, qt, kt, vt
    return out


def lm_summary(rows, per: str) -> dict:
    """Per-shape numbers summed over one prefill forward or one decode tick."""
    rows = [r for r in rows if r["per"] == per]
    tot = {key: sum(r[key] * r["count"] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    ops_ms = sum(r["bound_ms"] * r["count"] for r in rows if r["bound_by"] == "operations")
    tot["bound_by"] = "operations" if ops_ms >= tot["bound_ms"] / 2 else "bytes"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return tot


def phase_e(gen):
    """Full-width StarCoder2-3B prefill; returns (params, cfg, launches per forward)."""
    cfg = get_config(LM_ARCH)
    params = transformer.init_lm(cfg, generator=gen, device="cuda", dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    want = expected_launches(cfg)
    with torch.inference_mode():
        api.prefill_logits(params, cfg, batch)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            reset_counts()
            t0 = time.perf_counter()
            logits = api.prefill_logits(params, cfg, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            got = counts()
            check(got == want, f"prefill launches {got}, expected {want}")
        ref = api.prefill_logits(params, cfg, batch, use_kernel=False)
    check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab),
          f"logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    err = normalised_err(logits, ref)
    check(err <= TOL[torch.bfloat16], f"prefill vs plain: normalised error {err:.3e}")
    wall = statistics.median(walls)
    tokens_n = PREFILL_BATCH * PREFILL_SEQ
    print(f"E bfloat16 {LM_ARCH} prefill B={PREFILL_BATCH} S={PREFILL_SEQ} "
          f"({cfg.n_layers} layers, {cfg.param_count() / 1e9:.2f} B params): normalised error "
          f"{err:.3e}  launches {got}  wall {wall:.3f} ms (median of {len(walls)})  "
          f"{tokens_n / wall * 1e3:.1f} tokens/s")
    del logits, ref, tokens
    return params, cfg, got


def serving_requests(cfg) -> list:
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab,
                                                                 int(rng.integers(16, 65)))],
                    max_new=int(rng.integers(8, 17))) for i in range(N_REQUESTS)]


def phase_f(params, cfg) -> dict:
    """Full-width continuous-batching serving; returns launches over the counted ticks."""
    reqs = serving_requests(cfg)
    want = expected_launches(cfg, decode=True)
    b = ContinuousBatcher(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device="cuda")
    for r in reqs:
        b.submit(r)
    ticks, total = [], {name: 0 for name in WRAPPERS}
    max_logit_err = max_cache_err = 0.0
    while True:
        if b.steps < 4:  # the kernel decode step against the plain one, on the same cache
            b._admit()
            toks, pos = b._gather_inputs()
            with torch.inference_mode():
                lk, ck = api.decode_step(params, cfg, b.cache, toks, pos)
                lp, cp = api.decode_step(params, cfg, b.cache, toks, pos, use_kernel=False)
            e_logits = normalised_err(lk, lp)
            e_cache = max(normalised_err(ck[key], cp[key]) for key in ("k", "v"))
            check(e_logits <= TOL[torch.bfloat16] and e_cache <= TOL[torch.bfloat16],
                  f"decode tick {b.steps}: kernel vs plain logits {e_logits:.3e}, "
                  f"cache {e_cache:.3e}")
            max_logit_err, max_cache_err = max(max_logit_err, e_logits), max(max_cache_err,
                                                                              e_cache)
            del lk, ck, lp, cp
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if not b.step():  # the tick's argmax reaches the host, so the step has ended
            break
        ticks.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        check(got == want, f"tick {b.steps}: launches {got}, expected {want}")
        for name in total:
            total[name] += got[name]
    done = {c.rid: c for c in b.done}
    check(sorted(done) == [r.rid for r in reqs], f"completed {sorted(done)}")
    check(all(len(done[r.rid].tokens) == r.max_new for r in reqs), "a request stopped early")

    plain = ContinuousBatcher(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device="cuda",
                              use_kernel=False)
    for r in reqs:
        plain.submit(r)
    plain_done = {c.rid: c for c in plain.run()}
    check((plain.steps, plain.utilization) == (b.steps, b.utilization),
          f"steps/utilization {b.steps}/{b.utilization} vs plain "
          f"{plain.steps}/{plain.utilization}")
    same = sum(a == c for r in reqs
               for a, c in zip(done[r.rid].tokens, plain_done[r.rid].tokens))
    generated = sum(r.max_new for r in reqs)
    wall = sum(ticks)
    print(f"F bfloat16 {LM_ARCH} serving {N_REQUESTS} requests on {SLOTS} slots: "
          f"{b.steps} ticks  utilization {b.utilization:.4f} (plain route "
          f"{plain.utilization:.4f})  launches per tick {want}  decode vs plain on ticks 0-3: "
          f"logits {max_logit_err:.3e}, cache {max_cache_err:.3e}  tokens equal to the plain "
          f"route {same}/{generated}")
    print(f"F bfloat16 tick {statistics.median(ticks):.3f} ms (median), "
          f"{wall / len(ticks):.3f} ms (mean); {generated} generated tokens in {wall:.1f} ms "
          f"= {generated / wall * 1e3:.1f} generated tokens/s, "
          f"{b.busy_slot_steps / wall * 1e3:.1f} slot-tokens/s")
    return dict(total, ticks=b.steps, per_tick=want)


def lm_entries(rows, prefill_launches, serving) -> list:
    entries = []
    for name, (source, replaces) in LM_KERNELS.items():
        by = rows[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "dtype": "bfloat16", "per": "prefill forward",
                 "launches": prefill_launches[name],
                 **lm_summary(by[torch.bfloat16], "prefill"),
                 "float32": lm_summary(by[torch.float32], "prefill")}
        if name != "flash_attention":
            entry["decode_tick"] = {"launches": serving["per_tick"][name],
                                    **lm_summary(by[torch.bfloat16], "decode tick")}
        entry["serving_launches"] = serving[name]
        entries.append(entry)
    return entries


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
    torch.cuda.empty_cache()
    lm_rows = phase_d(gen)
    torch.cuda.empty_cache()
    params, cfg, prefill_launches = phase_e(gen)
    serving = phase_f(params, cfg)
    del params
    torch.cuda.empty_cache()

    entry = {"name": "conv2d", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
             "dtype": "float32", "launches": launches[torch.float32],
             **vgg_forward_summary(rows[torch.float32]),
             "bfloat16": {"launches": launches[torch.bfloat16],
                          **vgg_forward_summary(rows[torch.bfloat16])}}
    print(json.dumps({"kernels": [entry, *lm_entries(lm_rows, prefill_launches, serving)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
