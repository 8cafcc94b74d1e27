"""Gradients through the port's expert-parallel MoE (``moe._moe_mlp_ep``)
over four gloo ranks on the CPU, against ``jax.grad`` through the JAX
package's expert-parallel path and against autograd through the port's
dense dispatch on one process.

Kimi-K2 reduced (4 experts, top-2, a shared expert), fp32, one expert a
rank on a (data 1, model 4) mesh. The loss is ``sum(y * c) + 0.01 * aux``
for a fixed seeded ``c``, so both the output's and the load-balance term's
backward are taken. Each rank's expert leaves take their own experts'
gradients; the router, the shared expert and the input take the whole
layer's on every rank. JAX's EP needs a mesh of devices, so it runs in a
subprocess with four virtual CPU devices. Every gradient at 2e-4 relative
to the largest element of its reference.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, spawn_ranks  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.parallel import act  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCH, EP, AUX_W, TOL = "kimi-k2-1t-a32b", 4, 0.01, 2e-4
EXPERT_LEAVES = ("w_up", "w_gate", "w_down")

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import moe
from repro.parallel import act

cfg = get_config("kimi-k2-1t-a32b").reduced()
params = moe.init_moe_mlp(jax.random.key(0), cfg)
rng = np.random.default_rng(0)
x = jnp.asarray(rng.standard_normal((2, 16, cfg.d_model)), jnp.float32)
c = jnp.asarray(rng.standard_normal((2, 16, cfg.d_model)), jnp.float32)
mesh = jax.make_mesh((1, 4), ("data", "model"))
specs = dict(act.default_specs(mesh), _ep_mesh=(mesh, "model"))

def loss(x, p):
    y, aux = moe.moe_mlp(x, p, cfg)
    return jnp.sum(y * c) + 0.01 * aux

with mesh, act.activation_specs(specs):
    gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, params)
out = {"x": np.asarray(gx)}
for path, leaf in jax.tree_util.tree_flatten_with_path(gp)[0]:
    out["/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


def _inputs():
    cfg = jax_get_config(ARCH).reduced()
    params_np = jax.tree.map(np.asarray, jax_moe.init_moe_mlp(jax.random.key(0), cfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return params_np, x, c


def _grads(p, x, c, cfg):
    """(dL/dx, {leaf path: dL/dleaf}) of ``sum(y * c) + AUX_W * aux``."""
    leaves = dict(flatten(p))
    for t in [x, *leaves.values()]:
        t.requires_grad_()
    y, aux, _ = moe.moe_mlp(x, p, cfg)
    loss = torch.sum(y * c) + AUX_W * aux
    grads = torch.autograd.grad(loss, [x, *leaves.values()])
    return grads[0].numpy(), {k: g.numpy() for k, g in zip(leaves, grads[1:])}


def _ranks(rank, world, params_np, x_np, c_np):
    torch.set_num_threads(1)
    mesh = make_local_mesh(model=world, device_type="cpu")
    cfg = get_config(ARCH).reduced()
    p = transformer.params_from_jax(params_np, device="cpu")
    n_local = p["w_up"].shape[0] // world
    p = {k: v[rank * n_local:(rank + 1) * n_local].clone() if k in EXPERT_LEAVES else v
         for k, v in p.items()}
    with act.activation_specs(dict(act.default_specs(mesh), _ep_mesh=(mesh, "model"))):
        return _grads(p, torch.from_numpy(x_np), torch.from_numpy(c_np), cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    npz = tmp_path_factory.mktemp("jax") / "ep_grad.npz"
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(npz)],
                            env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    params_np, x_np, c_np = _inputs()
    ranks = spawn_ranks(_ranks, EP, backend="gloo", timeout=60, join_timeout=120,
                        args=(params_np, x_np, c_np))
    dense = _grads(transformer.params_from_jax(params_np, device="cpu"),
                   torch.from_numpy(x_np), torch.from_numpy(c_np), get_config(ARCH).reduced())
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"stdout={stdout}\nstderr={stderr[-3000:]}"
    return ranks, dense, dict(np.load(npz))


def _close(got, want, what):
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= TOL, f"{what}: {err:.3e}"


def _rank_slice(key, g, rank):
    if key in EXPERT_LEAVES:
        n_local = g.shape[0] // EP
        return g[rank * n_local:(rank + 1) * n_local]
    return g


@pytest.mark.parametrize("oracle", ["jax_ep", "dense"])
def test_ep_grads_match(runs, oracle):
    ranks, dense, jax_grads = runs
    want_x, want = (jax_grads["x"], jax_grads) if oracle == "jax_ep" else dense
    keys = sorted(ranks[0][1])
    assert keys == sorted(k for k in (dense[1]))
    for rank, (gx, gp) in enumerate(ranks):
        _close(gx, want_x, f"rank {rank} input")
        for k in keys:
            _close(gp[k], _rank_slice(k, want[k], rank), f"rank {rank} {k}")
    # every leaf is reached: the experts, the router and the shared expert
    assert all(np.any(g != 0) for g in ranks[0][1].values())


def test_ep_router_grad_is_the_layers_on_every_rank(runs):
    """Each rank's router gradient, its own part summed over the expert
    axis, is the same on every rank and equals the dense route's."""
    ranks, dense, _ = runs
    assert all(np.array_equal(r[1]["router"], ranks[0][1]["router"]) for r in ranks)
    np.testing.assert_allclose(ranks[0][1]["router"], dense[1]["router"], rtol=TOL, atol=1e-6)
