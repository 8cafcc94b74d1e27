"""The port's Zamba2 hybrid LM (repro_torch.models: ssm, recurrent, api)
against the JAX package's, at ``get_config("zamba2-2.7b").reduced()`` (4
Mamba2 layers in 2 groups, chunk 32): the JAX initialiser's weights are
carried across with ``params_from_jax`` and both packages get the same
numpy tokens. On the CPU every kernel of the port takes its plain version;
with ``use_kernel`` the JAX side runs its Pallas flash attention in
interpret mode through the ``attn_fn`` hook.

fp32 is held end to end at 2e-4 (normalised max|d|/max|ref|), prefill and
48 chained decode ticks with every cache key. In bf16 the random-weight
model is ill-conditioned: the gated RMSNorm after the scan divides by the
small RMS of the first positions, so one bf16 step at a block's input
grows several-fold at its output, and two compilations of the same JAX
forward (a Python loop and ``lax.scan`` over the groups) differ by ~0.18
in their logits. So bf16 is held block by block at 2e-2, every block fed
the JAX block's own input, and end to end no further from the fp32
logits than twice JAX's own bf16 forward is."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_attention.ops import attn_fn as jax_attn_fn  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import recurrent as jax_recurrent  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.models import api, layers, recurrent, ssm, transformer  # noqa: E402

ARCH = "zamba2-2.7b"
SEQS = [64, 16]  # two chunks of 32; one short chunk


@pytest.fixture(scope="module")
def zamba():
    jcfg = jax_get_config(ARCH).reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config(ARCH).reduced(), tparams


def _err(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _tokens(cfg, s, seed=3, batch=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, s))


def _jax_prefill(jcfg, jparams, toks, dtype, attn_fn=None):
    fn = jax.jit(lambda p, t: jax_recurrent.zamba_forward(p, jcfg, t, compute_dtype=dtype,
                                                          remat="none", attn_fn=attn_fn))
    return np.asarray(fn(jparams, jnp.asarray(toks)))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    ours, ref = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        ours, ref = ours.reduced(), ref.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.head_dim, ours.param_count(), ours.sub_quadratic) == \
        (ref.head_dim, ref.param_count(), ref.sub_quadratic)


def test_params_from_jax(zamba):
    jcfg, jparams, cfg, tparams = zamba
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(jax.tree.leaves(tparams))
    for path, leaf in flat:
        t = tparams
        for key in path:
            t = t[key.key]
        assert t.shape == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    groups = cfg.n_layers // cfg.shared_attn_every
    assert tparams["mamba"]["in_proj"].shape[:2] == (groups, cfg.shared_attn_every)


def test_init_zamba_matches_reference_tree(zamba):
    """The port's own initialiser gives the JAX tree's structure, shapes and
    scales (the values differ: torch.Generator is not jax.random)."""
    jcfg, jparams, cfg, _ = zamba
    ours = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.bfloat16)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(ours) == shapes(jparams)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(ours))
    m = ours["mamba"]
    assert abs(m["in_proj"].float().std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(m["conv_w"].float().std().item() / 0.1 - 1.0) < 0.1
    assert (m["a_log"] == 0).all() and (m["dt_bias"] == 0).all() and (m["d_skip"] == 1).all()


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_matches_jax_fp32(s, use_kernel, zamba):
    jcfg, jparams, cfg, tparams = zamba
    toks = _tokens(cfg, s)
    ref = _jax_prefill(jcfg, jparams, toks, jnp.float32, jax_attn_fn if use_kernel else None)
    before = ssd.launches
    out = api.prefill_logits(tparams, cfg, {"tokens": torch.from_numpy(toks)},
                             compute_dtype=torch.float32, use_kernel=use_kernel)
    assert ssd.launches == before  # CPU tensors take the plain versions
    assert out.dtype == torch.float32 and out.shape == (2, s, cfg.vocab)
    assert _err(out, ref) <= 2e-4


def _jax_blocks(jcfg, jparams):
    """Each block of the forward as its own compiled function x -> x + block(x)."""
    sh = jparams["shared"]
    norm = jax_layers.rms_norm
    mamba = jax.jit(lambda x, mp: x + jax_ssm.mamba2_apply(norm(x, jparams["mamba_ln"]), mp,
                                                           jcfg.ssm))
    attn = jax.jit(lambda x: x + jax_layers.gqa_attention(
        norm(x, sh["ln1"]), sh["attn"], jcfg.n_heads, jcfg.n_kv, rope=jcfg.rope,
        rope_theta=jcfg.rope_theta))
    mlp = jax.jit(lambda x: x + jax_layers.mlp(norm(x, sh["ln2"]), sh["mlp"], jcfg.activation))
    head = jax.jit(lambda x: (norm(x, jparams["ln_f"])
                              @ jparams["lm_head"].astype(x.dtype)).astype(jnp.float32))
    return mamba, attn, mlp, head


@pytest.mark.parametrize("s", SEQS)
def test_prefill_bf16_blocks_match_jax(s, zamba):
    """Every block of the bf16 forward, fed the JAX block's own input."""
    jcfg, jparams, cfg, tparams = zamba
    j_mamba, j_attn, j_mlp, j_head = _jax_blocks(jcfg, jparams)
    sh = tparams["shared"]
    x = jparams["embed"].astype(jnp.bfloat16)[jnp.asarray(_tokens(cfg, s))]
    errs = []
    for g in range(cfg.n_layers // cfg.shared_attn_every):
        for i in range(cfg.shared_attn_every):
            mp = transformer.layer(transformer.layer(tparams["mamba"], g), i)
            jx = j_mamba(x, jax.tree.map(lambda a: a[g, i], jparams["mamba"]))
            tx = _bf16(x)
            tx = tx + ssm.mamba2_apply(layers.rms_norm(tx, tparams["mamba_ln"]), mp, cfg.ssm)
            errs.append(("mamba", g, i, _err(_np(tx), jx)))
            x = jx
        tx = _bf16(x)
        tx = tx + layers.gqa_attention(layers.rms_norm(tx, sh["ln1"]), sh["attn"], cfg.n_heads,
                                       cfg.n_kv, rope=cfg.rope, rope_theta=cfg.rope_theta)
        x = j_attn(x)
        errs.append(("attn", g, 0, _err(_np(tx), x)))
        tx = _bf16(x)
        tx = tx + layers.mlp(layers.rms_norm(tx, sh["ln2"]), sh["mlp"], cfg.activation)
        x = j_mlp(x)
        errs.append(("mlp", g, 0, _err(_np(tx), x)))
    tx = layers.linear(layers.rms_norm(_bf16(x), tparams["ln_f"]), tparams["lm_head"]).float()
    errs.append(("head", 0, 0, _err(_np(tx), j_head(x))))
    assert len(errs) == cfg.n_layers + 2 * (cfg.n_layers // cfg.shared_attn_every) + 1
    assert max(e for *_, e in errs) <= 2e-2, errs


@pytest.mark.parametrize("s", SEQS)
def test_prefill_bf16_within_reference_rounding(s, zamba):
    jcfg, jparams, cfg, tparams = zamba
    toks = _tokens(cfg, s)
    ref32 = _jax_prefill(jcfg, jparams, toks, jnp.float32)
    ref16 = _jax_prefill(jcfg, jparams, toks, jnp.bfloat16)
    out = api.prefill_logits(tparams, cfg, {"tokens": torch.from_numpy(toks)},
                             compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and out.shape == (2, s, cfg.vocab)
    assert _err(out, ref32) <= 2 * _err(ref16, ref32)


def _decode_run(step, cache, toks, to_np):
    logits, caches = [], []
    for t in range(toks.shape[1]):
        pos = np.full((toks.shape[0],), t, np.int32)
        lg, cache = step(cache, toks[:, t:t + 1], pos)
        logits.append(to_np(lg))
        caches.append({k: to_np(v) for k, v in cache.items()})
    return logits, caches


def _jax_decode(jcfg, jparams, toks, dtype):
    step = jax.jit(lambda c, t, p: jax_api.decode_step(jparams, jcfg, c, t, p,
                                                       compute_dtype=dtype))
    cache = jax_api.init_cache(jcfg, toks.shape[0], 64, dtype=dtype)
    return _decode_run(lambda c, t, p: step(c, jnp.asarray(t), jnp.asarray(p)), cache, toks,
                       lambda a: np.asarray(a, np.float32))


def _port_decode(cfg, tparams, toks, dtype, use_kernel=True):
    cache = api.init_cache(cfg, toks.shape[0], 64, dtype, device="cpu")

    def step(c, t, p):
        with torch.inference_mode():
            return api.decode_step(tparams, cfg, c, torch.from_numpy(t),
                                   torch.from_numpy(p).long(), compute_dtype=dtype,
                                   use_kernel=use_kernel)

    return _decode_run(step, cache, toks, lambda t: t.float().numpy())


TICKS = 48


def test_decode_matches_jax_fp32_tick_by_tick(zamba):
    """48 teacher-forced ticks past the 32-row chunk; logits and every cache
    key (conv, ssm, k, v) after every tick."""
    jcfg, jparams, cfg, tparams = zamba
    toks = _tokens(cfg, TICKS, seed=4)
    jl, jc = _jax_decode(jcfg, jparams, toks, jnp.float32)
    tl, tc = _port_decode(cfg, tparams, toks, torch.float32)
    assert set(tc[0]) == set(jc[0]) == {"conv", "ssm", "k", "v"}
    for t in range(TICKS):
        assert _err(tl[t], jl[t]) <= 2e-4, t
        for key in jc[t]:
            assert tc[t][key].shape == jc[t][key].shape
            assert _err(tc[t][key], jc[t][key]) <= 2e-4, (t, key)


def test_decode_past_cache_end_matches_jax(zamba):
    """The hybrid's twin of test_torch_lm.py::test_decode_past_cache_end_matches_jax:
    positions 0..4 on a cache of s_max = 4; the attention write at pos 4 is
    dropped, as jax.nn.one_hot drops it, and the step still returns logits
    (ROADMAP queue 3, fault 6). fp32 at 2e-4, logits and every cache key."""
    jcfg, jparams, cfg, tparams = zamba
    s_max, steps = 4, 5
    toks = _tokens(cfg, steps, seed=5, batch=1)
    jcache = jax_api.init_cache(jcfg, 1, s_max, dtype=jnp.float32)
    tcache = api.init_cache(cfg, 1, s_max, torch.float32, device="cpu")
    for t in range(steps):
        pos = np.array([t], np.int32)
        jlogits, jcache = jax_api.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]),
                                              jnp.asarray(pos), compute_dtype=jnp.float32)
        with torch.inference_mode():
            logits, new = api.decode_step(tparams, cfg, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                          torch.from_numpy(pos).long(),
                                          compute_dtype=torch.float32)
        assert logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all())
        assert _err(_np(logits), jlogits) <= 2e-4, t
        for key in jcache:
            assert _err(_np(new[key]), jcache[key]) <= 2e-4, (t, key)
        if t >= s_max:  # the attention write past the cache is dropped
            assert torch.equal(new["k"], tcache["k"]) and torch.equal(new["v"], tcache["v"])
        tcache = new


def test_decode_bf16_blocks_match_jax(zamba):
    """Every Mamba2 layer's decode step in bf16, fed JAX's input and states
    on every one of 40 ticks: output and both new states at 2e-2."""
    jcfg, jparams, cfg, tparams = zamba
    step = jax.jit(lambda x, mp, cs, ss: jax_ssm.mamba2_decode(x, mp, jcfg.ssm, cs, ss))
    d_in = cfg.ssm.expansion * cfg.d_model
    n_h = d_in // cfg.ssm.head_dim
    rng = np.random.default_rng(5)
    for g in range(cfg.n_layers // cfg.shared_attn_every):
        for i in range(cfg.shared_attn_every):
            jmp = jax.tree.map(lambda a: a[g, i], jparams["mamba"])
            mp = transformer.layer(transformer.layer(tparams["mamba"], g), i)
            conv = jnp.zeros((2, cfg.ssm.conv_width - 1, d_in), jnp.bfloat16)
            state = jnp.zeros((2, n_h, cfg.ssm.head_dim, cfg.ssm.state_dim), jnp.float32)
            for t in range(40):
                x = jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)), jnp.bfloat16)
                y, new_conv, new_state = step(x, jmp, conv, state)
                ty, tconv, tstate = ssm.mamba2_decode(
                    _bf16(x), mp, cfg.ssm, _bf16(conv),
                    torch.from_numpy(np.asarray(state)))
                assert tconv.dtype == torch.bfloat16 and tstate.dtype == torch.float32
                for got, want in ((ty, y), (tconv, new_conv), (tstate, new_state)):
                    assert _err(_np(got), want) <= 2e-2, (g, i, t)
                conv, state = new_conv, new_state


def test_decode_bf16_within_reference_rounding(zamba):
    jcfg, jparams, cfg, tparams = zamba
    toks = _tokens(cfg, 40, seed=4)
    j32, _ = _jax_decode(jcfg, jparams, toks, jnp.float32)
    j16, _ = _jax_decode(jcfg, jparams, toks, jnp.bfloat16)
    t16, _ = _port_decode(cfg, tparams, toks, torch.bfloat16)
    ours = max(_err(a, b) for a, b in zip(t16, j32))
    theirs = max(_err(a, b) for a, b in zip(j16, j32))
    assert ours <= 2 * theirs, (ours, theirs)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_matches_prefill_last_token(use_kernel, zamba):
    """tests/test_arch_smoke.py::test_decode_matches_prefill_last_token, on the
    port: the recurrent decode reproduces the chunked prefill."""
    _, _, cfg, tparams = zamba
    seq = 64  # two chunks of 32
    toks = torch.from_numpy(_tokens(cfg, seq, seed=1, batch=1))
    full = api.prefill_logits(tparams, cfg, {"tokens": toks}, compute_dtype=torch.float32,
                              use_kernel=use_kernel)
    cache = api.init_cache(cfg, 1, seq, torch.float32, device="cpu")
    for t in range(seq):
        logits, cache = api.decode_step(tparams, cfg, cache, toks[:, t:t + 1],
                                        torch.tensor([t]), compute_dtype=torch.float32,
                                        use_kernel=use_kernel)
        torch.testing.assert_close(logits, full[:, t], atol=1e-3, rtol=1e-3)


def test_init_cache_matches_reference(zamba):
    jcfg, _, cfg, _ = zamba
    ref = jax_api.init_cache(jcfg, 3, 20)
    ours = api.init_cache(cfg, 3, 20, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ours.items()} == \
        {k: (tuple(v.shape), "torch." + str(v.dtype)) for k, v in ref.items()}
    assert all((v == 0).all() for v in ours.values())


def test_default_device_raises_without_cuda(zamba):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    *_, cfg, _ = zamba
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        recurrent.init_zamba(cfg, generator=gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(cfg, generator=gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(cfg, 1, 8)
