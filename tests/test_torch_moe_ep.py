"""The port's expert-parallel MoE (``moe._moe_mlp_ep``, reached through
``moe.moe_mlp`` when the activation specs name an ``_ep_mesh``) over four
gloo ranks on the CPU, against the JAX package's expert-parallel path and
against the port's own dense dispatch.

Kimi-K2 reduced: 4 experts, top-2, a shared expert; EP over a (data 1,
model 4) mesh, one expert a rank. The JAX initialiser's weights cross as
numpy arrays; each rank keeps its slice of the expert leaves. The JAX EP
path needs a mesh of devices, so it runs in a subprocess with four virtual
CPU devices (as tests/test_moe_ep.py runs it). y at 2e-5 and the aux loss
at 1e-5 in fp32, at the default capacity and at one that drops
assignments; bf16 against the dense bf16 dispatch at 2e-2; the kernel
route (one expert at a time; on the CPU the plain matmul) as the einsum
route.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, spawn_ranks  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.parallel import act  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCH, EP = "kimi-k2-1t-a32b", 4
EXPERT_LEAVES = ("w_up", "w_gate", "w_down")
# (capacity factor, dtype, use_kernel); None: the config's own factor
CASES = [(None, "float32", False), (None, "float32", True), (0.5, "float32", False),
         (None, "bfloat16", False)]
JAX_CFS = (None, 0.5)

JAX_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import moe
from repro.parallel import act

base = get_config("kimi-k2-1t-a32b").reduced()
params = moe.init_moe_mlp(jax.random.key(0), base)
x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 16, base.d_model)), jnp.float32)
mesh = jax.make_mesh((1, 4), ("data", "model"))
specs = act.default_specs(mesh)
specs["_ep_mesh"] = (mesh, "model")
out = {}
for cf in (None, 0.5):
    cfg = base if cf is None else dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
    with mesh, act.activation_specs(specs):
        y, aux = jax.jit(lambda x, p: moe.moe_mlp(x, p, cfg))(x, params)
    out[f"y_{cf}"], out[f"aux_{cf}"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[1], **out)
"""


def _cfg(cf):
    cfg = get_config(ARCH).reduced()
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _local(p, rank: int, ep: int):
    """This rank's share: its experts of each expert leaf, the rest whole."""
    n_local = p["w_up"].shape[0] // ep
    return {k: v[rank * n_local:(rank + 1) * n_local] if k in EXPERT_LEAVES else v
            for k, v in p.items()}


def _inputs(params_np, x_np, dtype):
    dt = getattr(torch, dtype)
    return (transformer.params_from_jax(params_np, device="cpu", dtype=dt),
            torch.from_numpy(x_np).to(dt))


def _ranks(rank, world, params_np, x_np):
    torch.set_num_threads(1)
    mesh = make_local_mesh(model=world, device_type="cpu")
    specs = dict(act.default_specs(mesh), _ep_mesh=(mesh, "model"))
    out = {}
    for cf, dtype, use_kernel in CASES:
        p, x = _inputs(params_np, x_np, dtype)
        with torch.no_grad(), act.activation_specs(specs):
            y, aux, dropped = moe.moe_mlp(x, _local(p, rank, world), _cfg(cf),
                                          use_kernel=use_kernel)
        out[(cf, dtype, use_kernel)] = (y.float().numpy(), aux.item(), int(dropped))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import moe as jax_moe

    npz = tmp_path_factory.mktemp("jax") / "ep.npz"
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(npz)],
                            env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    jcfg = jax_get_config(ARCH).reduced()
    params_np = jax.tree.map(np.asarray, jax_moe.init_moe_mlp(jax.random.key(0), jcfg))
    x_np = np.random.default_rng(0).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    ranks = spawn_ranks(_ranks, EP, backend="gloo", timeout=60, join_timeout=120,
                        args=(params_np, x_np))
    dense = {}
    for cf, dtype, use_kernel in CASES:
        p, x = _inputs(params_np, x_np, dtype)
        with torch.no_grad():
            y, aux, dropped = moe.moe_mlp(x, p, _cfg(cf), use_kernel=use_kernel)
        dense[(cf, dtype, use_kernel)] = (y.float().numpy(), aux.item(), int(dropped))
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"stdout={stdout}\nstderr={stderr[-3000:]}"
    return ranks, dense, dict(np.load(npz))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"cf{c[0]}-{c[1]}-kernel{c[2]}")
def test_ep_matches_the_dense_dispatch(runs, case):
    ranks, dense, _ = runs
    y, aux, dropped = dense[case]
    tol = 2e-2 if case[1] == "bfloat16" else 2e-5
    for r in ranks:  # every rank holds the whole reduced output
        got_y, got_aux, got_dropped = r[case]
        np.testing.assert_allclose(got_y, y, atol=tol, rtol=tol)
        assert abs(got_aux - aux) <= 1e-5
        assert got_dropped == dropped
    if case[0] == 0.5:
        assert dropped > 0  # the case drops assignments


@pytest.mark.parametrize("cf", JAX_CFS)
def test_ep_matches_jax_ep(runs, cf):
    ranks, _, jax_out = runs
    for r in ranks:
        y, aux, _ = r[(cf, "float32", False)]
        np.testing.assert_allclose(y, jax_out[f"y_{cf}"], atol=2e-5, rtol=2e-5)
        assert abs(aux - float(jax_out[f"aux_{cf}"])) <= 1e-5


def test_init_draws_a_ranks_slice_of_the_whole_layer():
    cfg = get_config(ARCH).reduced()
    whole_gen, part_gen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    whole = moe.init_moe_mlp(whole_gen, cfg)
    part = moe.init_moe_mlp(part_gen, cfg, experts=(1, 3))
    for k in EXPERT_LEAVES:
        assert part[k].shape[0] == 2
        torch.testing.assert_close(part[k], whole[k][1:3], rtol=0, atol=0)
    torch.testing.assert_close(part["router"], whole["router"], rtol=0, atol=0)
    torch.testing.assert_close(part["shared"]["w_down"], whole["shared"]["w_down"], rtol=0,
                               atol=0)
    assert torch.equal(part_gen.get_state(), whole_gen.get_state())
