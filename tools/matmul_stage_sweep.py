#!/usr/bin/env python3
"""Time the wgmma matmul's 128-row tile at other pipeline depths.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/matmul_stage_sweep.py [--variants 4,1 3,2 6,1]

Each variant "S,B" is ``matmul.cu`` with the 128 x 128 tile's
``Cfg<2, S, B>`` (S shared-memory stages, launch bounds for B blocks per
SM), compiled from a copy of the source (all variants at once, one nvcc
each) and loaded in place of the built library. For every bf16 product
shape of StarCoder2-3B's and Zamba2-2.7B's prefill (4 x 512 rows) it
checks the variant against ``matmul_ref`` and times it back to back as
``chip_smoke.py`` does (``b2b_ms`` over ``l2_copies``), in the order given, then torch.matmul, then the
variants in reverse; each variant keeps the lower of its two times. It
prints the per-shape times and the sums over one prefill forward.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matmul import matmul as launcher  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402

LARGE = "using Large = Cfg<2, 4, 1>;"


def build(variants: list[str], out_dir: Path) -> dict:
    """variant -> loaded library, each compiled from an edited copy of the source."""
    src_dir = _build.sources()["matmul"].parent
    text = (src_dir / "matmul.cu").read_text()
    if LARGE not in text:
        raise RuntimeError(f"matmul.cu no longer declares {LARGE!r}")
    jobs = {}
    for v in variants:
        stages, blocks = (int(x) for x in v.split(","))
        d = out_dir / f"s{stages}b{blocks}"
        d.mkdir()
        (d / "matmul.cu").write_text(text.replace(LARGE, f"using Large = Cfg<2, {stages}, {blocks}>;"))
        jobs[v] = (d / "libmatmul.so", subprocess.Popen(
            _build.command(d / "matmul.cu", d / "libmatmul.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {v}:\n{log}")
        lib = ctypes.CDLL(str(so))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_matmul.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, vp]
        lib.repro_matmul.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[v] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=["4,1", "3,2", "6,1"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matmul_stage_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(args.variants, Path(tmp))
        m = chip_smoke.PREFILL_BATCH * chip_smoke.PREFILL_SEQ
        order = args.variants + ["torch.matmul"] + args.variants[::-1]
        for arch in (chip_smoke.LM_ARCH, chip_smoke.HYBRID_ARCH):
            totals = dict.fromkeys(order, 0.0)
            for (k, n), count in chip_smoke.lm_products(get_config(arch)).items():
                a = torch.randn((m, k), device="cuda").to(torch.bfloat16)
                b = (torch.randn((k, n), device="cuda") * k ** -0.5).to(torch.bfloat16)
                ref, bs = matmul_ref(a, b).float(), chip_smoke.l2_copies(b)
                times: dict = {}
                for v in order:
                    if v == "torch.matmul":
                        t = chip_smoke.b2b_ms(lambda i: torch.matmul(a, bs[i % len(bs)]))
                    else:
                        launcher._lib = lambda lib=libs[v]: lib
                        chip_smoke.max_err_within(matmul(a, b), ref, chip_smoke.TOL[torch.bfloat16])
                        t = chip_smoke.b2b_ms(lambda i: matmul(a, bs[i % len(bs)]))
                    times[v] = min(times.get(v, t), t)
                for v, t in times.items():
                    totals[v] += t * count
                print(f"{arch} M={m} K={k} N={n} x{count}: "
                      + "  ".join(f"{v} {t:.4f} ms" for v, t in times.items()))
            print(f"{arch} prefill sum, back to back: "
                  + "  ".join(f"{v} {t:.3f} ms" for v, t in totals.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
