"""§Perf hill-climb: run one (arch x shape) cell under a named
optimization variant and record the roofline terms, so EXPERIMENTS.md §Perf
can show hypothesis -> change -> before/after.

The counterpart of ``repro/launch/hillclimb.py``, with its seven variants:
each a ``StepOptions`` and an activation-spec table (the port's tuple
specs), installed around the step as the reference installs its own; the
step is counted as the dry run counts it (``dryrun.count_step``: fake
tensors over a fake process group, rank 0's local shards).

On a DTensor mesh the port's MoE lays out its dispatch itself, experts
over ``model`` and tokens over the data axes, whatever the table says
(``models.moe._moe_mlp_mesh``), so the dispatch constraints that v1 adds
and the ``_ep_mesh`` that v6 names (it routes the MoE through
``_moe_mlp_ep``, which takes the same path on a DTensor) change nothing
there: v1's and v6's steps are v0's, and their records say so
(``same_step_as``, ``why``; :data:`SAME_AS_BASELINE`).

    python -m repro_torch.launch.hillclimb --cell kimi-k2-1t-a32b:train_4k \\
        --variant v2_bf16_cast --out results/perf_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import count_step, fake_world
from repro_torch.launch.hlo_stats import memory_summary
from repro_torch.parallel import act
from repro_torch.parallel.sharding import dp_spec
from repro_torch.train.steps import BASELINE, StepOptions


def _specs_baseline(mesh):
    """The act-spec table the 80-cell baseline sweep ran with (before the
    MoE dispatch constraints were added)."""
    s = act.default_specs(mesh)
    s.pop("experts_flat", None)
    s.pop("tokens_flat", None)
    return s


def _specs_seqpar(mesh):
    s = act.default_specs(mesh)
    # sequence-parallel residual stream: shard S over `model` between blocks
    s["act"] = (dp_spec(mesh), "model", None)
    return s


def _specs_ep_shardmap(mesh):
    s = act.default_specs(mesh)
    s["_ep_mesh"] = (mesh, "model")  # the MoE through _moe_mlp_ep
    return s


# the variants whose step on a DTensor mesh is v0's, and why
SAME_AS_BASELINE = {
    "v1_moe_dispatch": "the DTensor MoE lays out its dispatch itself (experts over model, "
                       "tokens over the data axes): the table's dispatch entries are not read",
    "v6_moe_ep_shardmap": "_moe_mlp_ep takes a DTensor to the same dispatch as v0's",
}

VARIANTS: dict[str, tuple[StepOptions, callable]] = {
    "v0_baseline": (BASELINE, _specs_baseline),
    "v1_moe_dispatch": (BASELINE, act.default_specs),
    "v2_bf16_cast": (StepOptions(cast_params=True), act.default_specs),
    "v3_rs_grads": (StepOptions(cast_params=True, constrain_grads=True),
                    act.default_specs),
    "v4_remat_dots": (StepOptions(cast_params=True, constrain_grads=True,
                                  remat="dots"), act.default_specs),
    "v5_seqpar": (StepOptions(cast_params=True, constrain_grads=True),
                  _specs_seqpar),
    "v6_moe_ep_shardmap": (BASELINE, _specs_ep_shardmap),
}


def run_variant(arch: str, shape_name: str, variant: str, multi_pod: bool = False, *,
                device_type: str = "cuda", mesh_shape: tuple[int, int] | None = None,
                reduced: bool = False) -> dict:
    """One variant's record. ``mesh_shape`` and ``reduced`` size it for tests,
    as in ``dryrun.run_cell``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if reduced:
        cfg, shape = cfg.reduced(), shape.reduced()
    opts, spec_fn = VARIANTS[variant]
    with fake_world(mesh_shape, multi_pod=multi_pod, device_type=device_type) as mesh:
        with act.activation_specs(spec_fn(mesh)):
            counter = count_step(cfg, shape, mesh, opts)
    rec = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "opts": dataclasses.asdict(opts),
        "exact": counter.exact().as_dict(),
        "memory": memory_summary(counter),
        "run_s": round(counter.run_s, 2),
        "device_type": device_type,
    }
    if variant in SAME_AS_BASELINE:
        rec.update(same_step_as="v0_baseline", why=SAME_AS_BASELINE[variant])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", choices=list(VARIANTS), required=True)
    ap.add_argument("--out", default="results/perf_torch")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the mesh's device type (fake tensors either way)")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    os.makedirs(args.out, exist_ok=True)
    tag = f"{arch}__{shape}__{args.variant}"
    print(f"[hillclimb] {tag}", flush=True)
    rec = run_variant(arch, shape, args.variant, device_type=args.device)
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    e = rec["exact"]
    print(f"  flops={e['flops']:.3e} coll={e['coll_total']:.3e} "
          f"mem_hlo={e['mem_bytes']:.3e} "
          f"temp/dev={rec['memory']['temp_size_in_bytes'] / 2**30:.1f}GiB "
          f"({rec['run_s']}s)")


if __name__ == "__main__":
    main()
