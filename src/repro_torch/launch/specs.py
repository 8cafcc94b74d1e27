"""Input specifications for every (arch x shape) cell.

The counterpart of ``repro/launch/specs.py``. ``input_specs`` gives
meta-device tensors (shapes and dtypes, no storage) for the dry run and for
``sharding.batch_pspecs``; ``make_batch`` draws small concrete batches for
tests and examples. Both take their shapes from ``_shapes_for``, and
``make_batch`` draws from ``np.random.default_rng(seed)`` the integers and
normals the reference draws, in its order, so the same seed gives the same
batch in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve
from repro_torch.models import api


def _shapes_for(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """name -> (shape tuple, dtype) for the given workload."""
    b, s = shape.global_batch, shape.seq_len
    out: dict[str, tuple[tuple, torch.dtype]] = {}
    if shape.kind in ("train", "prefill"):
        s_text = s
        if cfg.family == "vlm":
            s_text = s - cfg.n_patches
            out["patch_embeds"] = ((b, cfg.n_patches, cfg.vision_embed_dim), torch.bfloat16)
        if cfg.family == "audio":
            out["frames"] = ((b, cfg.n_audio_frames, cfg.d_model), torch.bfloat16)
        out["tokens"] = ((b, s_text), torch.int32)
        if shape.kind == "train":
            out["labels"] = ((b, s_text), torch.int32)
    else:  # decode: one new token against a cache of length s
        out["tokens"] = ((b, 1), torch.int32)
        out["pos"] = ((b,), torch.int32)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """name -> meta tensor; decode adds ``cache``, ``api.init_cache``'s tree
    on the meta device."""
    specs = {k: torch.empty(sh, dtype=dt, device="meta")
             for k, (sh, dt) in _shapes_for(cfg, shape).items()}
    if shape.kind == "decode":
        specs["cache"] = api.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    return specs


def make_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0, *, device="cuda") -> dict:
    """A concrete (small!) batch on ``device``: the reference's draws for
    ``seed``, in its dtypes (int32 ids, bfloat16 features)."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    batch = {}
    for k, (sh, dt) in _shapes_for(cfg, shape).items():
        if dt == torch.int32:
            hi = cfg.vocab if k in ("tokens", "labels") else shape.seq_len
            batch[k] = torch.from_numpy(rng.integers(0, hi, size=sh).astype(np.int32)).to(device)
        else:
            batch[k] = torch.from_numpy(rng.standard_normal(sh)).to(device, dt)
    if shape.kind == "decode":
        batch["pos"] = torch.full((shape.global_batch,), shape.seq_len - 1, dtype=torch.int32,
                                  device=device)
        batch["cache"] = api.init_cache(cfg, shape.global_batch, shape.seq_len, device=device)
    return batch
