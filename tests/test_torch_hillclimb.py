"""The hill-climb (``launch/hillclimb.py``): the reference's seven
variants, each run on a reduced MoE cell over a fake (2, 2) process group
on the CPU; a variant's table reaches the step, and the variants whose
step is v0's say so."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.launch import hillclimb  # noqa: E402


@pytest.fixture(scope="module")
def reference():
    # the reference module forces 512 host devices for its own process at
    # import; keep that setting from the rest of this one
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import hillclimb as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


def test_variants_and_options_are_the_reference(reference):
    assert list(hillclimb.VARIANTS) == list(reference.VARIANTS)
    for name, (opts, _) in hillclimb.VARIANTS.items():
        ref_opts = reference.VARIANTS[name][0]
        assert dataclasses.asdict(opts) == dataclasses.asdict(ref_opts), name


def test_spec_tables_name_the_reference_entries(reference):
    """Each variant's table has the reference's keys, and the seqpar table
    splits the residual stream's sequence over ``model``."""
    from repro_torch.parallel.act import default_specs

    mesh = {"data": 16, "model": 16}
    for name, (_, spec_fn) in hillclimb.VARIANTS.items():
        assert set(spec_fn(mesh)) <= set(default_specs(mesh)) | {"_ep_mesh"}, name
    assert "experts_flat" not in hillclimb._specs_baseline(mesh)
    assert hillclimb._specs_seqpar(mesh)["act"] == ("data", "model", None)


@pytest.fixture(scope="module")
def records():
    got = {}

    def get(variant):
        if variant not in got:
            got[variant] = hillclimb.run_variant("kimi-k2-1t-a32b", "train_4k", variant,
                                                 device_type="cpu", mesh_shape=(2, 2),
                                                 reduced=True)
        return got[variant]

    return get


@pytest.mark.parametrize("variant", list(hillclimb.VARIANTS))
def test_each_variant_runs_on_a_reduced_moe_cell(variant, records):
    rec = records(variant)
    assert rec["variant"] == variant and rec["exact"]["flops"] > 0
    assert rec["exact"]["coll_total"] > 0 and rec["memory"]["total_per_device"] > 0
    assert rec["opts"] == dataclasses.asdict(hillclimb.VARIANTS[variant][0])


def test_a_variants_table_reaches_the_step(records):
    """v5 differs from v3 by its table alone (the sequence split over
    ``model`` between blocks): the step it counts moves other bytes."""
    assert hillclimb.VARIANTS["v5_seqpar"][0] == hillclimb.VARIANTS["v3_rs_grads"][0]
    v3, v5 = records("v3_rs_grads")["exact"], records("v5_seqpar")["exact"]
    assert v5["flops"] == v3["flops"] and v5["coll_bytes"] != v3["coll_bytes"]


@pytest.mark.parametrize("variant", sorted(hillclimb.SAME_AS_BASELINE))
def test_variants_whose_step_is_the_baseline_say_so(variant, records):
    rec, v0 = records(variant), records("v0_baseline")
    assert rec["same_step_as"] == "v0_baseline" and rec["why"]
    assert rec["exact"] == v0["exact"] and rec["memory"] == v0["memory"]
    assert "same_step_as" not in v0
