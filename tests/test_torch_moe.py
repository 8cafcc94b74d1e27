"""The port's MoE decoder (repro_torch.models.moe, api's "moe" family)
against the JAX package's dense dispatch (``_moe_mlp_dense``), at the
reduced configs of Kimi-K2 (4 experts, top-2, a shared expert) and
Llama-4-Maverick (4 experts, top-1, a shared expert): the JAX
initialiser's weights are carried across with ``params_from_jax`` and both
packages get the same numpy inputs. The dispatch is held exactly (experts,
slots, kept assignments, counts, capacity), including a case that drops
assignments and one with tied router logits; outputs at 2e-4 in fp32 and
2e-2 in bf16 (normalised max|d| / max|ref|). On the CPU the port's kernel
wrappers take their plain versions, so ``use_kernel`` runs the per-expert
loop on the plain matmul."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_attention.ops import attn_fn as jax_attn_fn  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api, moe, transformer  # noqa: E402

ARCHS = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_get_config(arch).reduced()
            jparams = jax_api.init_params(jax.random.key(0), jcfg)
            tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams),
                                                  device="cpu")
            cache[arch] = (jcfg, jparams, get_config(arch).reduced(), tparams)
        return cache[arch]

    return get


def _err(out, ref) -> float:
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _jax_dispatch(expert_idx, jcfg):
    """The reference's slot computation (moe.py:_moe_mlp_dense), step for step."""
    e = jcfg.moe
    t = expert_idx.shape[0]
    flat_e = expert_idx.T.reshape(-1)
    counts = jnp.zeros((e.n_experts,), jnp.int32).at[flat_e].add(1)
    cap = max(int(math.ceil(t * e.top_k * e.capacity_factor / e.n_experts)), 4)
    kt = t * e.top_k
    order = jnp.argsort(flat_e, stable=True)
    starts = jnp.cumsum(counts) - counts
    slot_sorted = jnp.arange(kt, dtype=jnp.int32) - starts[flat_e[order]]
    slot = jnp.zeros((kt,), jnp.int32).at[order].set(slot_sorted)
    keep = slot < cap
    return flat_e, jnp.clip(slot, 0, cap - 1), keep, counts, cap


def _moe_layer(models, arch, cf=None):
    jcfg, jparams, cfg, tparams = models(arch)
    jp, tp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"]), \
        transformer.layer(tparams["blocks"], 0)["moe"]
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    for ours, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(), jax_get_config(arch).reduced())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert (ours.param_count(), ours.active_param_count()) == \
            (ref.param_count(), ref.active_param_count())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_reference_tree(arch, models):
    jcfg, jparams, cfg, tparams = models(arch)
    assert len(jax.tree.leaves(tparams)) == len(jax.tree.leaves(jparams))
    ours = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.bfloat16)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(ours) == shapes(jparams)
    w = ours["blocks"]["moe"]["w_down"].float()
    assert abs(w.std().item() * cfg.moe.d_ff_expert ** 0.5 - 1.0) < 0.05
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(ours))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t,cf", [(24, None), (40, 0.5), (3, None)])
def test_dispatch_matches_jax(arch, t, cf, models):
    """Experts, slots, kept mask, counts and capacity equal the reference's
    (cf 0.5 drops assignments; 3 tokens take the capacity floor of 4)."""
    jcfg, jp, cfg, tp = _moe_layer(models, arch, cf)
    x = np.random.default_rng(t).standard_normal((t, cfg.d_model)).astype(np.float32)
    _, _, _, idx = moe.route(torch.from_numpy(x), tp["router"], cfg)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(probs, jcfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    ours = moe.dispatch(idx, cfg)
    ref = _jax_dispatch(jidx, jcfg)
    for got, want in zip(ours[:4], ref[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ours[4] == ref[4] == moe.capacity(t, cfg)
    if cf == 0.5:
        assert int((~ours[2]).sum()) > 0


def test_top_k_ties_take_the_lower_expert(models):
    """Tied router probabilities: jax.lax.top_k puts the lower expert first, and
    so does the port's stable sort; the slots follow."""
    jcfg, jp, cfg, tp = _moe_layer(models, "kimi-k2-1t-a32b")
    t = 16
    x = np.zeros((t, cfg.d_model), np.float32)  # every logit 0: all four experts tie
    x[::4, 0] = 1.0
    router = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    router[0] = [0.0, 0.5, 0.5, 0.0]  # experts 1 and 2 tie above 0 and 3 on every 4th token
    _, _, gates, idx = moe.route(torch.from_numpy(x), torch.from_numpy(router), cfg)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1),
                            cfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[1].tolist() == [0, 1] and idx[0].tolist() == [1, 2]
    ours, ref = moe.dispatch(idx, cfg), _jax_dispatch(jidx, jcfg)
    for got, want in zip(ours[:4], ref[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_mlp_matches_jax(arch, name, cf, use_kernel, models):
    """The layer's output and aux loss; cf 0.5 drops assignments (counted)."""
    jcfg, jp, cfg, tp = _moe_layer(models, arch, cf)
    jdt, tdt = DTYPES[name]
    x = np.random.default_rng(11).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda x: jax_moe._moe_mlp_dense(x, jp, jcfg))(jnp.asarray(x, jdt))
    y, aux, dropped = moe.moe_mlp(torch.from_numpy(x).to(tdt), tp, cfg, use_kernel=use_kernel)
    assert y.dtype == tdt and y.shape == x.shape
    assert _err(y, jy) <= TOL[name]
    assert abs(aux.item() - float(jaux)) <= TOL[name] * abs(float(jaux))
    if cf == 0.5:
        assert int(dropped) > 0
    else:
        assert int(dropped) == 0


def test_aux_loss_counts_dropped_assignments(models):
    """counts, and so the aux loss, include assignments dropped over capacity:
    the aux loss does not move with the capacity factor."""
    _, _, cfg, tp = _moe_layer(models, "kimi-k2-1t-a32b")
    _, _, cfg_small, _ = _moe_layer(models, "kimi-k2-1t-a32b", 0.25)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((1, 32, cfg.d_model))
                         .astype(np.float32))
    _, aux, dropped = moe.moe_mlp(x, tp, cfg)
    _, aux_small, dropped_small = moe.moe_mlp(x, tp, cfg_small)
    assert int(dropped_small) > int(dropped) and aux.item() == aux_small.item()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_matches_jax(arch, name, use_kernel, models):
    jcfg, jparams, cfg, tparams = models(arch)
    jdt, tdt = DTYPES[name]
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (2, 24))
    ref = jax_moe.forward(jparams, jcfg, jnp.asarray(toks), compute_dtype=jdt, remat="none",
                          attn_fn=jax_attn_fn if use_kernel else None)[0]
    out = api.prefill_logits(tparams, cfg, {"tokens": torch.from_numpy(toks)},
                             compute_dtype=tdt, use_kernel=use_kernel)
    assert out.dtype == torch.float32 and out.shape == (2, 24, cfg.vocab)
    assert _err(out, ref) <= TOL[name]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_tick_by_tick(arch, models):
    """10 ticks of 3 sequences (capacity 4), logits and both caches, fp32."""
    jcfg, jparams, cfg, tparams = models(arch)
    toks = np.random.default_rng(14).integers(0, cfg.vocab, (3, 10))
    jcache = jax_api.init_cache(jcfg, 3, 16, dtype=jnp.float32)
    tcache = api.init_cache(cfg, 3, 16, torch.float32, device="cpu")
    jstep = jax.jit(lambda c, t, p: jax_api.decode_step(jparams, jcfg, c, t, p,
                                                        compute_dtype=jnp.float32))
    for t in range(10):
        pos = np.full((3,), t, np.int32)
        jlogits, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        with torch.inference_mode():
            logits, tcache = api.decode_step(tparams, cfg, tcache,
                                             torch.from_numpy(toks[:, t:t + 1]),
                                             torch.from_numpy(pos).long(),
                                             compute_dtype=torch.float32)
        assert _err(logits, jlogits) <= 2e-4, t
        for key in ("k", "v"):
            assert _err(tcache[key], jcache[key]) <= 2e-4, (t, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch, models):
    """Cross entropy plus 0.01 x the mean aux loss, fp32; and its gradient
    reaches every leaf."""
    jcfg, jparams, cfg, tparams = models(arch)
    rng = np.random.default_rng(15)
    toks, labels = rng.integers(0, cfg.vocab, (2, 16)), rng.integers(0, cfg.vocab, (2, 16))
    ref = jax_api.loss_fn(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)},
                          compute_dtype=jnp.float32)
    leaf = transformer.map_tree(lambda t: t.detach().requires_grad_(), tparams)
    loss = api.loss_fn(leaf, cfg, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)},
                       compute_dtype=torch.float32)
    assert abs(loss.item() - float(ref)) <= 2e-4 * abs(float(ref))
    grads = torch.autograd.grad(loss, jax.tree.leaves(leaf))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert sum(bool((g != 0).any()) for g in grads) == len(grads)
