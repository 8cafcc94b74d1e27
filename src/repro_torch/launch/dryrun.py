"""Multi-pod dry run: prove the distribution config is coherent, and count
what each step costs a rank.

The counterpart of ``repro/launch/dryrun.py``. For every (architecture x
input shape) cell it runs the step of ``train.steps.build_step(mesh=)``
(train, prefill or serve) once against the production mesh, 16x16 single
pod or 2x16x16 multi pod, and records the cost, memory and collective
traffic for the roofline analysis. The reference lowers and compiles the
step for 512 forced host devices and reads XLA's analyses. Here the step
runs on **fake tensors over a fake process group** of 256 or 512 ranks, as
rank 0: every tensor is a ``FakeTensor`` (a shape, a dtype and a device),
so no memory is allocated, no kernel launches and no byte moves, and
``hlo_stats.StepCounter`` counts that rank's work as the step runs (FLOPs
on its local shards, its collectives by kind, its bytes and its memory).
The fake process group (``torch.testing``'s ``fake`` backend, no peers) is
started inside ``run_cell`` and destroyed after it. The mesh's device type
is ``"cuda"`` unless the caller asks for ``"cpu"`` (``--device cpu``).

Records have the reference's keys and tags; ``lower_s`` and ``compile_s``
become ``run_s``, the wall of the fake step, and each record adds
``device_type`` and ``"counted": "local shards, rank 0"``. ``--unroll`` only
tags the record: the port's layers run one by one and are all counted.

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, SHAPES, cell_enabled, get_config
from repro_torch.launch.hlo_stats import StepCounter, cost_summary, memory_summary
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.specs import _shapes_for
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.train.steps import BASELINE, OPTIMIZED, build_step, init_params_on_mesh

COUNTED = "local shards, rank 0"


@contextlib.contextmanager
def fake_world(mesh_shape: tuple[int, ...] | None = None, *, multi_pod: bool = False,
               device_type: str = "cuda"):
    """A fake process group as rank 0 and a mesh over it: the production mesh
    (``multi_pod`` picks 2x16x16 over 16x16), or a (data, model) or (pod,
    data, model) mesh of ``mesh_shape``. Collectives of the group return at
    once and move nothing; run only fake tensors over it. The group is
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own (fake) process group; one is running")
    n = (512 if multi_pod else 256) if mesh_shape is None else math.prod(mesh_shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield (make_production_mesh(multi_pod=multi_pod, device_type=device_type)
               if mesh_shape is None else
               make_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):],
                         device_type=device_type))
    finally:
        dist.destroy_process_group()


def step_args(cfg, shape, mesh=None, *, device_type: str = "cuda",
              param_dtype=torch.float32) -> tuple:
    """The step's arguments, fake tensors: with a mesh, as the sharded step
    takes them, each rank's shards (the params of ``init_params_on_mesh``,
    the batch and the decode cache placed by ``sharding.batch_pspecs``);
    without one, whole on one device. The params (and, for a train step,
    the AdamW state beside them) in ``param_dtype``; the batch and the cache
    of ``launch/specs.py``'s shapes. Run under ``FakeTensorMode``."""
    dev = device_type if mesh is None else mesh.device_type
    if mesh is None:
        params = api.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                 device=dev, dtype=param_dtype)
    else:
        params = init_params_on_mesh(cfg, mesh, seed=0, dtype=param_dtype)
    batch = {k: torch.empty(sh, dtype=dt, device=dev)
             for k, (sh, dt) in _shapes_for(cfg, shape).items()}
    if shape.kind == "decode":
        batch["cache"] = api.init_cache(cfg, shape.global_batch, shape.seq_len, device=dev)
    if mesh is not None:
        specs = shd.batch_pspecs(cfg, shape, batch, mesh)
        batch = {k: shd.distribute(v, specs[k], mesh) for k, v in batch.items()}
    if shape.kind == "train":
        return params, adamw.init(params), batch
    if shape.kind == "prefill":
        return params, batch
    return params, batch["cache"], batch["tokens"], batch["pos"]


def count_step(cfg, shape, mesh, opts, *, param_dtype=torch.float32) -> StepCounter:
    """The sharded step of ``shape.kind`` run once on fake tensors, counted."""
    counter = StepCounter()
    with FakeTensorMode():
        args = step_args(cfg, shape, mesh, param_dtype=param_dtype)
        counter.run(build_step(cfg, shape, mesh=mesh, opts=opts), *args)
    return counter


def count_unsharded(cfg, shape, *, device_type: str = "cuda") -> StepCounter:
    """The whole step of ``shape.kind`` on one device, run once on fake
    tensors and counted: what a mesh's ranks share. Prefill and decode take
    the plain route, whose products are the kernels' formula for formula:
    there the MoE runs its experts as one batched product, not one at a
    time."""
    counter = StepCounter()
    with FakeTensorMode():
        args = step_args(cfg, shape, device_type=device_type)
        if shape.kind == "train":
            step = build_step(cfg, shape, device=device_type)
        elif shape.kind == "prefill":
            step = torch.no_grad()(lambda p, b: api.prefill_logits(p, cfg, b, remat="none",
                                                                   use_kernel=False))
        else:
            step = torch.no_grad()(lambda p, c, t, q: api.decode_step(p, cfg, c, t, q,
                                                                      use_kernel=False))
        counter.run(step, *args)
    return counter


def record(counter: StepCounter) -> dict:
    """The counted fields of a record: the reference's ``cost``, ``memory``,
    ``collectives`` and ``exact``, and the wall of the fake step."""
    st = counter.collective_stats()
    return {"run_s": round(counter.run_s, 2), "cost": cost_summary(counter),
            "memory": memory_summary(counter),
            "collectives": {"bytes_by_kind": st.bytes_by_kind,
                            "count_by_kind": st.count_by_kind,
                            "total_bytes": st.total_bytes, "total_count": st.total_count},
            "exact": counter.exact().as_dict()}


def run_cell(arch: str, shape_name: str, multi_pod: bool, unroll: bool = False,
             optimized: bool = False, device_type: str = "cuda", *,
             mesh_shape: tuple[int, int] | None = None, reduced: bool = False) -> dict:
    """One cell's record. ``mesh_shape`` (a (data, model) mesh) and ``reduced``
    (the arch's and the shape's ``.reduced()``) size a cell for tests."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if reduced:
        cfg, shape = cfg.reduced(), shape.reduced()
    mesh_name = "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"
    if mesh_shape is not None:
        mesh_name = "x".join(map(str, mesh_shape))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    ok, why = cell_enabled(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    rec["unroll"] = unroll
    rec["optimized"] = optimized
    opts = OPTIMIZED if optimized else BASELINE
    with fake_world(mesh_shape, multi_pod=multi_pod, device_type=device_type) as mesh:
        counter = count_step(cfg, shape, mesh, opts)
        n_devices = mesh.size()
    rec.update(status="ok", n_devices=n_devices, device_type=device_type, counted=COUNTED,
               **record(counter))
    return rec


def _cell(job: tuple) -> dict:
    arch, shape, multi_pod, unroll, optimized, device_type = job
    try:
        return run_cell(arch, shape, multi_pod, unroll, optimized, device_type)
    except Exception as e:  # record the failure, keep going
        return {"arch": arch, "shape": shape, "mesh": "multi" if multi_pod else "single",
                "status": "error", "error": repr(e), "traceback": traceback.format_exc()}


def run_cells(jobs: list[tuple], workers: int = 1):
    """``run_cell(*job)`` for each job, in ``workers`` spawned processes (each
    its own fake process group), yielding (job, record) as each ends; a cell
    that raises gives a ``status: error`` record with its traceback."""
    if workers <= 1:
        for job in jobs:
            yield job, _cell(job)
        return
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor, as_completed

    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as pool:
        futures = {pool.submit(_cell, job): job for job in jobs}
        for fut in as_completed(futures):
            yield futures[fut], fut.result()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--unroll", action="store_true",
                    help="tag the records only: every layer is run and counted")
    ap.add_argument("--opt", action="store_true",
                    help="use the adopted §Perf optimizations (remat=dots, "
                         "bf16 cast, grad constraints)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the mesh's device type (fake tensors either way)")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all else [args.arch]
    shapes = list(SHAPES) if args.all else ([args.shape] if args.shape else list(SHAPES))
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_all = time.perf_counter()
    jobs, paths = [], {}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                if args.unroll:
                    tag += "__unroll"
                if args.opt:
                    tag += "__opt"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip existing] {tag}")
                    continue
                job = (arch, shape, mp, args.unroll, args.opt, args.device)
                jobs.append(job)
                paths[job] = (tag, path)
    for job, rec in run_cells(jobs, args.workers):
        tag, path = paths[job]
        failures += rec["status"] == "error"
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "ok":
            m = rec["memory"]
            print(f"[dryrun] {tag} ok: flops={rec['cost']['flops']:.3e} "
                  f"bytes={rec['cost']['bytes_accessed']:.3e} "
                  f"coll={rec['collectives']['total_bytes']:.3e} "
                  f"mem/dev={m['total_per_device'] / 2**30:.2f}GiB "
                  f"(run {rec['run_s']}s)", flush=True)
        else:
            print(f"[dryrun] {tag} {rec['status']}: {rec.get('reason') or rec.get('error')}",
                  flush=True)
    print(f"done, {failures} failures ({time.perf_counter() - t_all:.1f} s)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
