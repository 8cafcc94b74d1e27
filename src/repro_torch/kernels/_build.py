"""Build the port's CUDA sources on first use and load them with ctypes.

Each kernel directory holds one source, ``<name>/csrc/<name>.cu``, with a
plain C interface (no PyTorch headers, so ``nvcc`` takes seconds). Every
source is compiled by its own ``nvcc`` process, all started together, into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout. Headers
shared by several kernels (the Hopper helpers) live in ``kernels/include/``,
which nvcc gets with ``-I``. The hash covers the sources of the kernel's
directory, every shared header and the flags, so an edited source or header
builds anew and an unchanged one is loaded from the cache. A failed build
raises with nvcc's stderr.

Nothing here runs when the module is imported: the CPU tests import every
module of the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "include"
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"

# sm_90a (not sm_90) keeps wgmma and setmaxnreg available to the sources;
# -Xptxas -v writes each kernel's registers, shared memory and spills to the
# build log beside the library.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> dict[str, Path]:
    """Kernel name -> its CUDA source."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def command(src: Path, out: Path) -> list[str]:
    """The nvcc command line that builds ``src`` into the library ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(out), str(src)]


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the .cu and any .cuh beside it, then the shared headers
    for f in [*sorted(src.parent.glob("*.cu*")), *sorted(INCLUDE_DIR.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) for a built kernel."""
    return _target(sources()[name]).with_suffix(".log").read_text()


@functools.cache
def build_all() -> dict[str, Path]:
    """Compile every source that is not cached yet; return name -> library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, jobs = {}, []
    for name, src in sources().items():
        out = libs[name] = _target(src)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(command(src, Path(tmp)),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:  # wait for every job, failed or not
        log, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    return ctypes.CDLL(str(build_all()[name]))
