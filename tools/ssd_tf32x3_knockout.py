"""Where the SSD's fp32 route (tf32x3) spends its time: knockout builds.

Card only. Builds copies of ``kernels/ssd/csrc/ssd.cu`` under
``build/knockout/``, each with one step of the tf32x3 route removed (its
output is then wrong: only its time is read), one nvcc process a copy, all
started together, and times each copy's two kernels at Zamba2-2.7B's fp32
prefill shape (x (4, 512, 80, 64), b and c (4, 512, 64), chunk 256) by
``torch.profiler``, device microseconds a call by kernel (the median of
three rounds over every copy in turn). What a step costs is the base's
time less the copy's. Each copy is loaded and launched through the
launcher's own binding (``ssd.bind``, ``ssd.ssd_scan(lib=)``); the copies
find their steps by exact source text, so an edit to one of those lines
makes the tool stop and name it.

    python3 tools/ssd_tf32x3_knockout.py [--only NAME,...]
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import ssd as launcher  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/ssd/csrc/ssd.cu"
OUT = ROOT / "build/knockout"
SHAPE, CHUNK = (4, 512, 80, 64, 64), 256
ROUNDS = 3

# name -> the text of the tf32x3 route that the copy drops
KNOCKOUTS = {
    "base": [],
    "outputs: C split": ["  split_in_place<NA, NT>(tp, tp + HALF_BYTES, tid);  // C of both tiles\n"
                         "  split_in_place<NA, NT>(tp + SPLIT_BYTES, tp + SPLIT_BYTES + HALF_BYTES, "
                         "tid);\n"],
    "outputs: scan": ["  chunk_scan64<NT>(dt + (size_t)b * g.s * g.h + h, g.h, t0, "
                      "min((last + 1) * TILE, g.q), a[h],\n                   dts, dhi, dlo, part, "
                      "tid);\n"],
    "outputs: B split": ["    split_in_place<NA, NT>(bp, bp + HALF_BYTES, tid);  // B_j\n"],
    "outputs: x transpose": ["    transpose_split<NT, true>(bp + SPLIT_BYTES, tp + (sx - tiles), "
                             "tp + (sx - tiles) + HALF_BYTES,\n                              nullptr, "
                             "TILE, tid);  // x_j^T, in the A fragment's order\n"],
    "outputs: S wgmma": ["        tf32x3_stage<64, ATOM_F32>(s, scw + at * ATOM_BYTES, "
                         "scw + HALF_BYTES + at * ATOM_BYTES,\n                                   "
                         "bs + at * ATOM_BYTES, bs + HALF_BYTES + at * ATOM_BYTES,\n"
                         "                                   at == 0);\n"],
    "outputs: G exponents": [("    if (jt == it) {\n", "    if (jt < 0) {\n"),
                             "          for (int hh = 0; hh < 2; ++hh) s[4 * j + 2 * hh + bb] "
                             "*= u[hh] * w;\n"],
    "outputs: Gx wgmma": ["      wgmma_m64n64k8_tf32_rs(pv, gl[k], xh, k > 0);\n"
                          "      wgmma_m64n64k8_tf32_rs(pv, gh[k], xl);\n"
                          "      wgmma_m64n64k8_tf32_rs(pv, gh[k], xh);\n"],
    "states: transposes": ["      transpose_split<NT, false>(xs, tp + (sxw - tiles), "
                           "tp + (sxw - tiles) + HALF_BYTES,\n                                 "
                           "ws + t * TILE, g.q - t * TILE, tid);\n"
                           "      transpose_split<NT, false>(xs + HALF_BYTES, tp + (sbt - tiles),\n"
                           "                                 tp + (sbt - tiles) + HALF_BYTES, "
                           "nullptr, TILE, tid);\n"],
}


def variant(name: str, edits) -> Path:
    """A copy of ssd.cu with ``edits`` applied to its tf32x3 route (``namespace tf``)."""
    text = SRC.read_text()
    i, j = text.index("namespace tf {"), text.index("}  // namespace tf")
    tf = text[i:j]
    for edit in edits:
        old, new = edit if isinstance(edit, tuple) else (edit, "")
        if tf.count(old) != 1:
            raise SystemExit(f"{name}: the text to drop is not in the tf32x3 route once: {old!r}")
        tf = tf.replace(old, new)
    d = OUT / name.replace(": ", "_").replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "ssd.cu").write_text(text[:i] + tf + text[j:])
    return d


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default="", help="comma-separated knockout names")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("ssd_tf32x3_knockout: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    names = [n for n in KNOCKOUTS if not args.only or n in args.only.split(",") or n == "base"]
    dirs = {n: variant(n, KNOCKOUTS[n]) for n in names}
    procs = {n: subprocess.Popen(_build.command(d / "ssd.cu", d / "libssd.so"),
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, d in dirs.items()}
    for n, pr in procs.items():
        log = pr.communicate()[0]
        if pr.returncode:
            raise SystemExit(f"{n}: nvcc failed\n{log[-4000:]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, a_log, b, c = cs.ssd_inputs(*SHAPE, torch.float32, gen)
    q = CHUNK
    a = -torch.exp(a_log)
    out = torch.empty_like(x)
    states = launcher.state_scratch(x, q, "tf32x3")
    calls = {n: functools.partial(launcher.ssd_scan, x, dt, a, b, c, out, q, "tf32x3", states,
                                  lib=launcher.bind(ctypes.CDLL(str(d / "libssd.so"))))
             for n, d in dirs.items()}
    # every copy in turn, ROUNDS times, so that the card's drift shows as
    # spread and not as a saving
    times = {n: {} for n in calls}
    for _ in range(ROUNDS):
        for n, call in calls.items():
            us = cs.device_us_by_kernel(call)
            for k, v in us.items():
                if "tf32x3" in k:
                    times[n].setdefault(k.replace("_tf32x3", ""), []).append(v)
    med = {n: {k: statistics.median(v) for k, v in t.items()} for n, t in times.items()}
    for n, us in med.items():
        print(f"{n:24s} " + "  ".join(
            f"{k} {v:8.1f} us (saves {med['base'][k] - v:6.1f}; rounds "
            f"{', '.join(f'{t:.1f}' for t in times[n][k])})" for k, v in sorted(us.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
