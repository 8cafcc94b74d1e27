"""The port's distributed GPipe (repro_torch.parallel.pipeline with a mesh)
and the two paths that run it, ``cnn.hybrid_forward(mesh=)`` and
``hybrid_lm_forward(mesh=)``, over gloo ranks on the CPU, against the JAX
package.

Four ranks start once for the module (``launch.mesh.spawn_ranks``:
FileStore rendezvous, 60 s collective timeout). The JAX side's pipelined
forwards need a mesh of devices, so they run in a subprocess with four
virtual CPU devices, as tests/test_pipeline_multidev.py runs them; the
gradients are held to ``jax.grad`` of the sequential loss in this process
(on jax 0.9.0 the gradient of the reference's pipelined loss raises:
ROADMAP.md queue 1 item 2). Inputs come from numpy seeds and JAX's
initialisers; weights cross as numpy arrays through ``params_from_jax``.

(a) 4 stages of ``tanh(h @ w)``: forward at 1e-5, gradients at 1e-4 (the
    stage weights', and the replicated input's on every rank); with stage
    0's weight frozen and an input needing no grad, the backward still
    completes on every rank.
(b) a homogeneous conv group (SP = 4, 4 microbatches) against JAX's
    ``hybrid_forward(mesh=)`` at 1e-4, its stage-weight gradients against
    the sequential loss's; a head holding a pool against JAX's sequential
    route (the reference's mesh route crashes there: queue 3, fault 1).
(c) StarCoder2-3B reduced, deepened to 4 layers (2 head blocks, 2 tail
    blocks), over a (data 2, stage 2) mesh, fp32, against JAX's pipelined
    forward at 1e-4 and ``jax.grad`` of its sequential ``hybrid_lm_loss``.
"""
import dataclasses
import inspect
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import netinfo  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_ranks  # noqa: E402
from repro_torch.models import cnn, transformer  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_apply, split_microbatches  # noqa: E402
from repro_torch.train.hybrid import HybridLMPlan, hybrid_lm_forward, hybrid_lm_loss  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
D, N_STAGES, N_MICRO = 16, 4, 4
LM_ARCH, LM_LAYERS, LM_PLAN = "starcoder2-3b", 4, HybridLMPlan(sp=2, n_stages=2, n_micro=2)
GROUP_PLAN = cnn.HybridPlan(sp=4, n_micro=4)


def _group_net(ni):  # a deepened-VGG group: 4 x conv(8) head, pool, 2 x conv(16)
    b = ni._B("group", 12, 12, 8)
    for _ in range(4):
        b.conv(8, 3)
    b.pool(2)
    b.conv(16, 3).conv(16, 3)
    return b.done()


def _pool_net(ni):  # sp = 4 takes conv, conv, pool, conv
    b = ni._B("pool_head", 12, 12, 8)
    b.conv(8, 3).conv(8, 3).pool(2).conv(8, 3).conv(16, 3)
    return b.done()


def _inputs():
    """The numpy inputs both sides draw: (a) weights and rows, the conv
    nets' inputs, the LM's tokens."""
    return {"ws": np.random.default_rng(0).standard_normal((N_STAGES, D, D)) * 0.3,
            "x": np.random.default_rng(1).standard_normal((8, D)),
            "img": np.random.default_rng(2).standard_normal((8, 8, 12, 12)),
            "tokens": np.random.default_rng(3).integers(0, 512, (4, 16))}


JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core import netinfo
from repro.models import api, cnn
from repro.parallel.pipeline import pipeline_apply, split_microbatches
from repro.train.hybrid import HybridLMPlan, hybrid_lm_forward

inp = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("stage",))
ws, x = jnp.asarray(inp["ws"], jnp.float32), jnp.asarray(inp["x"], jnp.float32)
out = {"a": pipeline_apply(lambda w, h: jnp.tanh(h @ w), ws, split_microbatches(x, 4), mesh)}
net = _group_net(netinfo)
params = cnn.init_vgg(jax.random.key(0), net)
out["b"] = cnn.hybrid_forward(params, net, jnp.asarray(inp["img"], jnp.float32),
                              cnn.HybridPlan(sp=4, n_micro=4), mesh=mesh)
cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(), n_layers=4)
out["c"] = hybrid_lm_forward(api.init_params(jax.random.key(0), cfg), cfg,
                             jnp.asarray(inp["tokens"]), HybridLMPlan(2, 2, 2),
                             jax.make_mesh((2,), ("stage",)), compute_dtype=jnp.float32)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""
# the subprocess builds the conv group as this module does, without importing torch
JAX_SCRIPT = JAX_SCRIPT.replace("inp = np.load", inspect.getsource(_group_net) + "\ninp = np.load")


def _ranks(rank, world, inp, group_params, pool_params, lm_params):
    """Every case on this rank; the results as numpy arrays."""
    torch.set_num_threads(1)
    out = {}
    stages = make_mesh((world,), ("stage",), device_type="cpu")

    # (a) tanh(h @ w), this rank's stage only, the loss on the replicated output
    calls = [0]

    def stage(w, h):
        calls[0] += 1
        return torch.tanh(h @ w)

    w = torch.tensor(inp["ws"][rank], dtype=torch.float32, requires_grad=True)
    x = torch.tensor(inp["x"], dtype=torch.float32, requires_grad=True)
    y = pipeline_apply(stage, w, split_microbatches(x, N_MICRO), stages)
    y.sum().backward()
    out["a"], out["a_grad"], out["a_calls"] = y.detach().numpy(), w.grad.numpy(), calls[0]
    out["a_x_grad"] = x.grad.numpy()
    # stage 0 frozen, the input needing no grad: stage 0's rank still takes
    # part in every backward exchange
    w = torch.tensor(inp["ws"][rank], dtype=torch.float32, requires_grad=rank > 0)
    pipeline_apply(stage, w, split_microbatches(x.detach(), N_MICRO), stages).sum().backward()
    out["a_frozen_grad"] = None if w.grad is None else w.grad.numpy()

    # (b) the conv group: this rank holds its own head weight only
    net, img = _group_net(netinfo), torch.tensor(inp["img"], dtype=torch.float32)
    own = [p if (i >= GROUP_PLAN.sp or i == rank) else None
           for i, p in enumerate(cnn.params_from_jax(group_params, device="cpu"))]
    out["b"] = cnn.hybrid_forward(own, net, img, GROUP_PLAN, mesh=stages).numpy()
    own[rank].requires_grad_(True)
    cnn.hybrid_forward(own, net, img, GROUP_PLAN, mesh=stages, use_kernel=False).sum().backward()
    out["b_grad"] = own[rank].grad.numpy()
    pool = cnn.params_from_jax(pool_params, device="cpu")
    out["b_pool"] = cnn.hybrid_forward(pool, _pool_net(netinfo), img, GROUP_PLAN,
                                       mesh=stages).numpy()
    try:
        cnn.hybrid_forward(own, net, img, cnn.HybridPlan(sp=2, n_micro=4), mesh=stages)
        out["b_sp_refused"] = False
    except ValueError:
        out["b_sp_refused"] = True

    # (c) the LM over (data 2, stage 2): every rank holds the whole model
    dp_pp = make_mesh((2, 2), ("data", "stage"), device_type="cpu")
    cfg = dataclasses.replace(get_config(LM_ARCH).reduced(), n_layers=LM_LAYERS)
    params = transformer.params_from_jax(lm_params, device="cpu")
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.tensor(inp["tokens"])
    kw = {"compute_dtype": torch.float32, "use_kernel": False}
    with torch.no_grad():
        out["c"] = hybrid_lm_forward(params, cfg, tokens, LM_PLAN, dp_pp, **kw).numpy()
    hybrid_lm_loss(params, cfg, tokens, tokens, LM_PLAN, dp_pp, **kw).backward()
    out["c_grad"] = {k: v.grad.numpy() for k, v in flatten(params)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.core import netinfo as jax_netinfo
    from repro.models import api as jax_api
    from repro.models import cnn as jax_cnn
    from repro.train.hybrid import HybridLMPlan as JaxPlan
    from repro.train.hybrid import hybrid_lm_loss

    tmp = tmp_path_factory.mktemp("jax")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / "inputs.npz"),
                             str(tmp / "pipelined.npz")], env=dict(os.environ, PYTHONPATH=SRC),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    group = jax_cnn.init_vgg(jax.random.key(0), _group_net(jax_netinfo))
    pool = jax_cnn.init_vgg(jax.random.key(1), _pool_net(jax_netinfo))
    jcfg = dataclasses.replace(jax_get_config(LM_ARCH).reduced(), n_layers=LM_LAYERS)
    lm = jax_api.init_params(jax.random.key(0), jcfg)
    as_np = [None if p is None else np.asarray(p) for p in group]
    pool_np = [None if p is None else np.asarray(p) for p in pool]
    lm_np = jax.tree.map(np.asarray, lm)
    # the ranks run while this process computes the sequential references
    with ThreadPoolExecutor(1) as threads:
        ranks = threads.submit(spawn_ranks, _ranks, 4, backend="gloo", timeout=60,
                               join_timeout=120, args=(inp, as_np, pool_np, lm_np))
        ws, x = jnp.asarray(inp["ws"], jnp.float32), jnp.asarray(inp["x"], jnp.float32)

        def seq(ws, x):
            h = x
            for i in range(N_STAGES):
                h = jnp.tanh(h @ ws[i])
            return h.sum()

        img = jnp.asarray(inp["img"], jnp.float32)
        net = _group_net(jax_netinfo)
        toks = jnp.asarray(inp["tokens"])
        ref = {
            **dict(zip(["a_grad", "a_x_grad"], map(np.asarray, jax.grad(seq, (0, 1))(ws, x)))),
            "b_grad": np.asarray(jax.grad(
                lambda p: jax_cnn.forward(p, net, img).sum())(group)[:4]),
            "b_pool": np.asarray(jax_cnn.hybrid_forward(pool, _pool_net(jax_netinfo), img,
                                                        jax_cnn.HybridPlan(sp=4, n_micro=4))),
            "c_grad": dict(flatten(jax.tree.map(np.asarray, jax.jit(jax.grad(
                lambda p: hybrid_lm_loss(p, jcfg, toks, toks, JaxPlan(2, 2, 2),
                                         compute_dtype=jnp.float32)))(lm)))),
        }
        ranks = ranks.result()
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"stdout={stdout}\nstderr={stderr[-3000:]}"
    ref.update(np.load(tmp / "pipelined.npz"))
    return ranks, ref


def test_pipeline_forward_matches_jax_mesh(runs):
    ranks, ref = runs
    for r in ranks:  # every rank holds the last stage's outputs
        np.testing.assert_allclose(r["a"], ref["a"], atol=1e-5)


def test_pipeline_grads_match_sequential_loss(runs):
    """Each rank's stage weight, the loss computed on every rank: the
    sequential loss's gradient, not n_stages times it."""
    ranks, ref = runs
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["a_grad"], ref["a_grad"][rank], atol=1e-4)


def test_pipeline_input_grad_is_replicated(runs):
    """The microbatches are a replicated input that stage 0 alone reads:
    every rank gets the sequential loss's gradient of them."""
    ranks, ref = runs
    for r in ranks:
        np.testing.assert_allclose(r["a_x_grad"], ref["a_x_grad"], atol=1e-4)


def test_pipeline_backward_with_a_frozen_first_stage(runs):
    """No weight or input of stage 0 needs a grad; its rank still records
    every hand-off, so the backward ends and the other stages' gradients are
    the sequential loss's."""
    ranks, ref = runs
    assert ranks[0]["a_frozen_grad"] is None
    for rank, r in enumerate(ranks[1:], 1):
        np.testing.assert_allclose(r["a_frozen_grad"], ref["a_grad"][rank], atol=1e-4)


def test_pipeline_calls_every_stage_at_every_tick(runs):
    ranks, _ = runs
    assert [r["a_calls"] for r in ranks] == [N_MICRO + N_STAGES - 1] * N_STAGES


def test_hybrid_forward_matches_jax_mesh(runs):
    ranks, ref = runs
    for r in ranks:
        np.testing.assert_allclose(r["b"], ref["b"], atol=1e-4, rtol=1e-4)


def test_hybrid_forward_stage_grads_match_sequential_loss(runs):
    ranks, ref = runs
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["b_grad"], ref["b_grad"][rank], atol=1e-4, rtol=1e-4)


def test_hybrid_forward_pool_head_runs_sequentially(runs):
    ranks, ref = runs
    for r in ranks:
        np.testing.assert_allclose(r["b_pool"], ref["b_pool"], atol=1e-4, rtol=1e-4)


def test_hybrid_forward_refuses_sp_unlike_the_stages(runs):
    ranks, _ = runs
    assert all(r["b_sp_refused"] for r in ranks)


def test_hybrid_lm_forward_matches_jax_mesh(runs):
    ranks, ref = runs
    for r in ranks:
        np.testing.assert_allclose(r["c"], ref["c"], atol=1e-4, rtol=1e-4)


def test_hybrid_lm_grads_match_jax_sequential_loss(runs):
    """Rank (data d, stage s) = 2 d + s holds the gradient of stage s's head
    blocks and of every tail block; the embedding, ln_f and the head are
    replicated and every rank holds their whole gradient."""
    ranks, ref = runs
    lps, sp = LM_PLAN.layers_per_stage, LM_PLAN.sp
    assert LM_LAYERS > sp  # the tail's gradients are compared too
    for rank, r in enumerate(ranks):
        s = rank % LM_PLAN.n_stages
        rows = list(range(s * lps, (s + 1) * lps)) + list(range(sp, LM_LAYERS))
        for key, want in ref["c_grad"].items():
            got = r["c_grad"][key]
            if key.startswith("blocks/"):  # (L, ...): this stage's head rows and the tail
                got, want = got[rows], want[rows]
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                       err_msg=f"rank {rank}: {key}")


@pytest.mark.parametrize("fn", ["cnn", "lm"])
def test_mesh_and_pipelined_are_exclusive(fn):
    with pytest.raises(ValueError, match="one or the other"):
        if fn == "cnn":
            net = _group_net(netinfo)
            cnn.hybrid_forward([None] * len(net.layers), net, torch.zeros(4, 8, 12, 12),
                               GROUP_PLAN, pipelined=True, mesh=object())
        else:
            hybrid_lm_forward({}, get_config(LM_ARCH).reduced(), torch.zeros(4, 16), LM_PLAN,
                              object(), pipelined=True)
