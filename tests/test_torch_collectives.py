"""The port's ``compressed_psum`` (repro_torch.parallel.collectives) over four
gloo ranks on the CPU, against the JAX package's ``compressed_psum`` under
``shard_map`` (a subprocess with four virtual CPU devices; it runs on jax
0.9.0) and against the formula in numpy: per leaf, ``acc = g + err`` is
quantized to int8 with each rank's own scale, the int8 values summed as
int32 and the scales reduced by max, the sum dequantized with the max
scale; the new error is ``acc - q * scale`` with the rank's own scale.
Everything is held exactly: the same fp32 operations in the same order.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD = 4
SHAPES = {"a": (8, 5), "b": (7,), "blocks": {"w": (3, 4, 6)}}

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.parallel.compat import shard_map
from repro.parallel.collectives import compressed_psum

inp = np.load(sys.argv[1])
unflat = lambda pre: {"a": inp[f"{pre}/a"], "b": inp[f"{pre}/b"],
                      "blocks": {"w": inp[f"{pre}/blocks/w"]}}
g, e = unflat("g"), unflat("e")
first = lambda t: jax.tree.map(lambda a: a[0], t)
lead = lambda t: jax.tree.map(lambda a: a[None], t)
body = lambda g, e: tuple(lead(t) for t in compressed_psum(first(g), "dp", first(e)))
fn = shard_map(body, mesh=jax.make_mesh((4,), ("dp",)), in_specs=(P("dp"), P("dp")),
               out_specs=(P("dp"), P("dp")), check_vma=False)
s, ne = fn(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
flat = lambda t, pre: {f"{pre}/{'/'.join(str(k.key) for k in path)}": np.asarray(v)
                       for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
np.savez(sys.argv[2], **flat(s, "sum"), **flat(ne, "err"))
"""


def _inputs():
    """Every rank's grads and error feedback, stacked on a leading rank axis
    (fp32, seeded): the grads at a few scales so that the ranks' scales differ."""
    rng = np.random.default_rng(0)

    def draw(shape, scale):
        return (rng.standard_normal((WORLD,) + shape)
                * scale * np.arange(1, WORLD + 1).reshape((WORLD,) + (1,) * len(shape))
                ).astype(np.float32)

    def tree(shapes, scale):
        return {k: tree(v, scale) if isinstance(v, dict) else draw(v, scale)
                for k, v in shapes.items()}

    return tree(SHAPES, 1.0), tree(SHAPES, 0.01)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _ranks(rank, world):
    torch.set_num_threads(1)

    def mine(t):  # this rank's row of every leaf
        return {k: mine(v) if isinstance(v, dict) else torch.from_numpy(v[rank])
                for k, v in t.items()}

    grads, err = (mine(t) for t in _inputs())
    before = {k: v.clone() for k, v in _flat(grads).items()}
    total, new_err = collectives.compressed_psum(grads, None, err)
    unchanged = all(torch.equal(before[k], v) for k, v in _flat(grads).items())
    return ({k: v.numpy() for k, v in _flat(total).items()},
            {k: v.numpy() for k, v in _flat(new_err).items()}, unchanged)


def _formula():
    """The sum every rank gets and each rank's new error, in numpy."""
    g, e = _inputs()
    total, errs = {}, {}
    for key, gs in _flat(g).items():
        acc = gs + _flat(e)[key]                                       # (world, ...)
        amax = np.abs(acc.reshape(WORLD, -1)).max(1)
        scale = (np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)).astype(np.float32)
        sc = scale.reshape((WORLD,) + (1,) * (acc.ndim - 1))
        q = np.clip(np.round(acc / sc), -127, 127).astype(np.int8)
        total[key] = q.astype(np.int32).sum(0).astype(np.float32) * scale.max()
        errs[key] = acc - q.astype(np.float32) * sc
    return total, errs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("jax")
    g, e = _inputs()
    np.savez(tmp / "inputs.npz", **{f"g/{k}": v for k, v in _flat(g).items()},
             **{f"e/{k}": v for k, v in _flat(e).items()})
    npz = tmp / "psum.npz"
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / "inputs.npz"),
                             str(npz)], env=dict(os.environ, PYTHONPATH=SRC),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = spawn_ranks(_ranks, WORLD, backend="gloo", timeout=60, join_timeout=120)
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"stdout={stdout}\nstderr={stderr[-3000:]}"
    return ranks, dict(np.load(npz))


@pytest.mark.parametrize("key", list(_flat(SHAPES)))
def test_compressed_psum_matches_jax_exactly(runs, key):
    ranks, jax_out = runs
    for rank, (total, err, _) in enumerate(ranks):
        np.testing.assert_array_equal(total[key], jax_out[f"sum/{key}"][rank])
        np.testing.assert_array_equal(err[key], jax_out[f"err/{key}"][rank])


@pytest.mark.parametrize("key", list(_flat(SHAPES)))
def test_compressed_psum_matches_the_formula_exactly(runs, key):
    ranks, _ = runs
    total, errs = _formula()
    for rank, (got_total, got_err, _) in enumerate(ranks):
        np.testing.assert_array_equal(got_total[key], total[key])
        np.testing.assert_array_equal(got_err[key], errs[key][rank])


def test_compressed_psum_leaves_its_inputs(runs):
    ranks, _ = runs
    assert all(unchanged for _, _, unchanged in ranks)
