"""The port's sharding rules (repro_torch.parallel.sharding) and activation
specs (repro_torch.parallel.act) against the JAX package's, spec for spec.

The JAX rules read only a mesh's axis names and sizes, so they run here on
``jax.sharding.AbstractMesh`` meshes that no device backs; the port's run
on the same sizes given as ``{axis: size}`` mappings. Every arch at full
size (shapes from ``jax.eval_shape``, carried over as meta tensors) on a
(data 4, model 4) and a (pod 2, data 2, model 4) mesh: params, the decode
cache, and the inputs of each workload shape; JAX's ``PartitionSpec`` is
compared as a tuple. ``placements`` is checked on four gloo ranks: a
tensor distributed by the placements of its spec has the local shape the
spec implies; there too the meshes refuse a process group of another size.
``spawn_ranks`` ends a run whose rank fails or hangs.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.specs import input_specs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.parallel import act as jax_act  # noqa: E402
from repro.parallel import sharding as jax_shd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh, make_mesh,  # noqa: E402
                                     make_production_mesh, spawn_ranks)
from repro_torch.parallel import act, sharding  # noqa: E402

MESHES = {"data4-model4": {"data": 4, "model": 4},
          "pod2-data2-model4": {"pod": 2, "data": 2, "model": 4}}


def _abstract(sizes: dict) -> AbstractMesh:
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _meta(shapes):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)


@pytest.fixture(scope="module")
def param_shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jax_get_config(arch)
            cache[arch] = jax.eval_shape(lambda: jax_api.init_params(jax.random.key(0), cfg))
        return cache[arch]

    return get


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_jax(arch, mesh, param_shapes):
    shapes = param_shapes(arch)
    want = _tuples(jax_shd.param_pspecs(shapes, _abstract(MESHES[mesh])))
    assert sharding.param_pspecs(_meta(shapes), MESHES[mesh]) == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_pspecs_equal_jax(arch, mesh):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for shape in SHAPES.values():
        specs = input_specs(jcfg, shape)
        want = _tuples(jax_shd.batch_pspecs(jcfg, shape, specs, _abstract(MESHES[mesh])))
        got = sharding.batch_pspecs(cfg, shape, _meta(specs), MESHES[mesh])
        assert got == want, shape.name
        if "cache" in specs:
            assert sharding.cache_pspecs(cfg, _meta(specs["cache"]), MESHES[mesh]) == \
                want["cache"]


@pytest.mark.parametrize("spec,shape,want", [
    (("data", "model"), (51865, 512), (None, "model")),
    (("data", "model"), (512, 51865), ("data", None)),
    ((("data", "model"),), (4,), ("data",)),
    (("data",), (1,), (None,)),
    (("data", "model"), (7, 5), (None, None)),
    ((None, "model", "data"), (3, 8), (None, "model", None)),
])
def test_fit_spec_on_a_wide_mesh(spec, shape, want):
    """tests/test_sharding.py's 16-way cases on a {data: 4, model: 4} mapping,
    beside JAX's fit_spec on the same sizes."""
    sizes = MESHES["data4-model4"]
    assert sharding.fit_spec(spec, shape, sizes) == want
    assert tuple(jax_shd.fit_spec(P(*spec), shape, _abstract(sizes))) == want


@pytest.mark.parametrize("mesh", MESHES)
def test_default_activation_specs_equal_jax(mesh):
    assert act.default_specs(MESHES[mesh]) == \
        _tuples(jax_act.default_specs(_abstract(MESHES[mesh])))
    assert sharding.fsdp_axes(MESHES[mesh]) == jax_shd.fsdp_axes(_abstract(MESHES[mesh]))


def test_ep_mesh_follows_the_installed_specs():
    assert act.ep_mesh() is None
    with act.activation_specs({"_ep_mesh": ("m", "model")}):
        assert act.ep_mesh() == ("m", "model")
        with act.activation_specs(None):
            assert act.ep_mesh() is None
    assert act.ep_mesh() is None
    act.use_activation_specs({"_ep_mesh": ("m", "model")})
    try:
        assert act.ep_mesh() == ("m", "model")
    finally:
        act.use_activation_specs(None)


CASES = {"embed": (("data", "model"), (64, 32)), "wo": (("model", "data"), (32, 64)),
         "stacked": ((None, "data", "model"), (3, 16, 8)), "scale": ((), (32,)),
         "both": ((("data", "model"),), (8, 6))}


def _placement_ranks(rank, world):
    from torch.distributed.tensor import distribute_tensor

    mesh = make_local_mesh(model=2, device_type="cpu")  # (data 2, model 2)
    out = {"refused": []}
    for make in (lambda: make_production_mesh(device_type="cpu"),
                 lambda: make_production_mesh(multi_pod=True, device_type="cpu"),
                 lambda: make_local_mesh(model=3, device_type="cpu")):
        try:
            make()
            out["refused"].append(False)
        except ValueError:
            out["refused"].append(True)
    for name, (spec, shape) in CASES.items():
        full = torch.arange(float(np.prod(shape))).reshape(shape)
        local = distribute_tensor(full, mesh, sharding.placements(spec, mesh)).to_local()
        out[name] = tuple(local.shape)
    return out


@pytest.fixture(scope="module")
def placement_ranks():
    return spawn_ranks(_placement_ranks, 4, backend="gloo", timeout=60, join_timeout=120)


def test_meshes_refuse_a_world_of_another_size(placement_ranks):
    """256 and 512 ranks, and a model axis that does not divide 4, on 4 ranks."""
    assert all(r["refused"] == [True, True, True] for r in placement_ranks)


def test_a_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((1,), ("stage",))


def _failing_rank(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()  # rank 1 never arrives


def _sleeping_rank(rank, world):
    time.sleep(300)


def test_spawn_ranks_ends_the_run_at_a_failed_rank():
    """Rank 1 fails while rank 0 waits in a barrier that would time out
    only after 300 s: the run raises a rank's failure (rank 0's barrier may
    fail first, its peer gone), not the join timeout."""
    with pytest.raises(RuntimeError, match=r"rank [01] of 2 failed"):
        spawn_ranks(_failing_rank, 2, backend="gloo", timeout=300, join_timeout=240)


def test_spawn_ranks_ends_a_hung_run():
    with pytest.raises(TimeoutError, match="still running after 8 s"):
        spawn_ranks(_sleeping_rank, 1, backend="gloo", timeout=60, join_timeout=8)


def test_placements_shard_as_the_spec_says(placement_ranks):
    ranks = placement_ranks
    sizes = {"data": 2, "model": 2}
    for name, (spec, shape) in CASES.items():
        want = tuple(n // int(np.prod([sizes[a] for a in (e if isinstance(e, tuple) else (e,))]))
                     if e else n for n, e in zip(shape, spec + (None,) * len(shape)))
        assert all(r[name] == want for r in ranks), (name, [r[name] for r in ranks], want)
