"""Device meshes and the ranks behind them.

The counterpart of ``repro/launch/mesh.py``: ``make_local_mesh`` and
``make_production_mesh`` build ``torch.distributed`` device meshes with the
reference's shapes and axis names. Nothing here touches a process group when
the module is imported.

A mesh needs a process group, one process per rank. ``spawn_ranks`` starts
them: ``world_size`` processes by the ``spawn`` start method, each joining
a group of the ``backend`` it is given through a ``FileStore`` in a fresh
temporary directory (no TCP port, so concurrent runs do not collide), with
a ``timeout`` on every collective so that a send nobody receives fails
instead of hanging. Each rank runs ``fn(rank, world_size, *args)`` and the
parent returns their results in rank order; the first rank that fails, or
a run that outlives ``join_timeout`` seconds, raises and ends every rank.

What the layers below need of a mesh (an axis's group, the axes' sizes) is
in ``parallel.collectives``.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve
from repro_torch.parallel.collectives import blocking_functional_collectives


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the ranks of the default process group (the
    counterpart of ``jax.make_mesh``); the group must hold exactly that many
    ranks. A CUDA mesh over gloo runs DTensor's collectives blocking
    (``collectives.blocking_functional_collectives``)."""
    resolve(device_type)
    if device_type == "cuda" and dist.get_backend() == "gloo":
        blocking_functional_collectives("cuda")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_local_mesh(model: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the process group as a (world // model, model) mesh."""
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"{world} ranks do not split into a model axis of {model}")
    return make_mesh((world // model, model), ("data", "model"), device_type=device_type)


def _rank_main(fn, rank: int, world_size: int, backend: str, store_path: str,
               timeout: float, result_path: str, args: tuple) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world_size, *args)
        torch.save(out, result_path)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *, backend: str, timeout: float,
                join_timeout: float, args: tuple = ()) -> list:
    """``fn(rank, world_size, *args)`` in ``world_size`` spawned processes of one
    process group; their return values (saved with ``torch.save``, so keep
    tensors in them on the CPU) in rank order.

    ``fn`` must be importable by name (a module-level function). ``timeout``
    (seconds) bounds every collective of the group; ``join_timeout``
    (seconds) bounds the whole run. Raises as soon as a rank exits non-zero,
    or when the run outlives ``join_timeout``; no rank is left running
    either way.
    """
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        results = [os.path.join(tmp, f"result{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, os.path.join(tmp, "store"),
                                   timeout, results[r], args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout
        try:
            running = {p.sentinel: r for r, p in enumerate(procs)}
            while running:  # the first rank to fail ends the run
                ready = wait(list(running), timeout=max(0.0, deadline - time.monotonic()))
                if not ready:
                    raise TimeoutError(f"ranks {sorted(running.values())} of {world_size} still "
                                       f"running after {join_timeout} s")
                for sentinel in ready:
                    r = running.pop(sentinel)
                    procs[r].join()
                    if procs[r].exitcode:
                        raise RuntimeError(f"rank {r} of {world_size} failed (exit code "
                                           f"{procs[r].exitcode})")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(path, weights_only=False) for path in results]
