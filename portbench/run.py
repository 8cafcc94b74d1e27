"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The kernels' build cache is the program's own
``build/kernels`` inside the checkout; the caches of torch and of the CUDA
driver are pointed inside it too, at fixed paths, so only a checkout's
first run builds anything.
"""
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The epoch second this process started (Linux: from /proc), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        boot = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime "))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T0 = process_start()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench" / "cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

if __name__ == "__main__":
    from portbench.harness import runner
    sys.exit(runner.main(sys.argv[1:], T0))
