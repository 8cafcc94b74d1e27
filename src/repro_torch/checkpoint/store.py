"""Fault-tolerant checkpointing: atomic snapshots with a manifest and
auto-resume, in the JAX package's layout.

The counterpart of ``repro/checkpoint/store.py``::

    <dir>/step_000123/
        manifest.json     # step, flat keys, tree spec, device count, user meta
        arrays.npz        # flattened param/opt arrays (on the host)
    <dir>/LATEST          # atomically-renamed pointer file

The leaves are flattened under the reference's key names
(``repro_torch.tree.flatten``: ``params/blocks/attn/wq``, ``opt/.mu/...``,
``opt/.count``), so a checkpoint written by either package restores in
the other. Write protocol: write into ``step_X.tmp-<nonce>``, fsync,
rename to ``step_X``, then rewrite LATEST — a crash at any point leaves
either the previous checkpoint or a complete new one. NumPy has no
bfloat16: a bfloat16 leaf is stored as its 16-bit words in a 2-byte void
array, the bytes and dtype the JAX package writes for its ``ml_dtypes``
bfloat16 arrays, and read back into a bfloat16 ``like`` leaf (the JAX
package's own ``restore`` cannot cast that dtype: ROADMAP.md queue 3,
fault 8).

Sharded trees (DTensor leaves, a Trainer on a mesh) are saved as the
global arrays: every rank of the default group calls ``save``, each leaf
is gathered, and rank 0 alone writes, in the layout above. ``restore``
with ``placements`` (a tree of ``(mesh, placements)`` pairs,
``parallel.sharding.shardings``; the counterpart of the reference's
``shardings``) places each global array onto the current mesh, whatever
mesh wrote it: the elastic-rescale path.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import place
from repro_torch.tree import flatten, leaves, map_tree, map_with_path


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:  # as the JAX package's bfloat16 arrays land: 2-byte void
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in flatten(tree)}


def save(ckpt_dir: str, step: int, tree, meta: dict | None = None) -> str:
    """Atomic checkpoint write. Returns the final directory path. A tree
    with DTensor leaves is collective: every rank calls it, and it returns
    once rank 0 has written."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = _flatten(tree)
    if any(isinstance(leaf, DTensor) for leaf in leaves(tree)):
        if dist.get_rank() == 0:
            _write(ckpt_dir, final, step, tree, flat, meta, dist.get_world_size())
        dist.barrier()
    else:
        _write(ckpt_dir, final, step, tree, flat, meta, 1)
    return final


def _write(ckpt_dir: str, final: str, step: int, tree, flat: dict, meta: dict | None,
           n_devices: int) -> None:
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat.keys()),
        "treedef": [key for key, _ in flatten(tree)],
        "n_devices": n_devices,
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest_tmp = os.path.join(ckpt_dir, f".LATEST.tmp-{uuid.uuid4().hex[:8]}")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))


def latest_step(ckpt_dir: str) -> int | None:
    """Newest complete checkpoint step, verified against the manifest: the
    LATEST pointer first, then a scan of the step directories, newest first;
    a torn manifest is skipped for an older one."""
    pointer = os.path.join(ckpt_dir, "LATEST")
    candidates = []
    if os.path.exists(pointer):
        with open(pointer) as f:
            candidates.append(f.read().strip())
    if os.path.isdir(ckpt_dir):  # fall back to a directory scan
        candidates += sorted((d for d in os.listdir(ckpt_dir)
                              if d.startswith("step_") and ".tmp" not in d),
                             reverse=True)
    for name in candidates:
        mf = os.path.join(ckpt_dir, name, "manifest.json")
        if os.path.exists(mf):
            try:
                with open(mf) as f:
                    return int(json.load(f)["step"])
            except (ValueError, KeyError, json.JSONDecodeError):
                continue  # torn manifest -> try older
    return None


def _tensor(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device if device is None else device, dtype=like.dtype)


def restore(ckpt_dir: str, step: int, like_tree, *, device=None, placements=None):
    """Load ``step`` into the structure, shapes and dtypes of ``like_tree``,
    each leaf on ``device`` (by default the like leaf's own). ``placements``
    (a tree of ``(mesh, placements)`` pairs matching ``like_tree``, None for
    a leaf left plain) reshards each global array onto its mesh."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}

    def leaf(key, like):
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: ckpt shape {arr.shape} != {tuple(like.shape)}")
        return _tensor(arr, like, device)

    tree = map_with_path(leaf, like_tree)
    if placements is None:
        return tree
    return map_tree(lambda t, where: t if where is None else place(t, *where), tree, placements,
                    is_leaf=lambda x: isinstance(x, torch.Tensor))


def meta(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)
