"""The port's xLSTM (repro_torch.models: ssm's mLSTM and sLSTM cells,
recurrent's xLSTM LM, api's "ssm" family) against the JAX package's, at
``get_config("xlstm-350m").reduced()`` (an mLSTM block then an sLSTM block,
d 128, 4 heads of 32, chunk 32): the JAX initialiser's weights are carried
across with ``params_from_jax`` (the blocks are a Python list) and both
packages get the same numpy inputs. On the CPU the port's kernel wrappers
take their plain versions, so ``use_kernel`` runs the same arithmetic.
fp32 is held at 2e-4 and bf16 at 2e-2 (normalised max|d| / max|ref|)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import recurrent as jax_recurrent  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.models import api, recurrent, ssm, transformer  # noqa: E402

ARCH = "xlstm-350m"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def xlstm():
    jcfg = jax_get_config(ARCH).reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config(ARCH).reduced(), tparams


def _err(out, ref) -> float:
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _x(shape, seed, name):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _cell(jparams, tparams, kind):
    """(JAX params, port params) of the first block of ``kind``."""
    i = next(i for i, bp in enumerate(jparams["blocks"]) if kind in bp)
    return jparams["blocks"][i][kind], tparams["blocks"][i][kind]


def test_params_from_jax_carries_the_block_list(xlstm):
    jcfg, jparams, cfg, tparams = xlstm
    assert isinstance(tparams["blocks"], list) and len(tparams["blocks"]) == cfg.n_layers
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(jax.tree.leaves(tparams))
    for path, leaf in flat:
        t = tparams
        for key in path:
            t = t[key.idx if hasattr(key, "idx") else key.key]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    kinds = [next(k for k in bp if k.startswith("kind_")) for bp in tparams["blocks"]]
    assert kinds == ["kind_mlstm", "kind_slstm"]


def test_init_xlstm_matches_reference_tree(xlstm):
    """The port's own initialiser gives the JAX tree's structure, shapes and
    scales (the values differ: torch.Generator is not jax.random)."""
    jcfg, jparams, cfg, _ = xlstm
    ours = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.bfloat16)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(ours) == shapes(jparams)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(ours))
    wq = ours["blocks"][0]["kind_mlstm"]["wq"].float()
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("s", [64, 96, 16])  # two and three chunks of 32; one short chunk
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mlstm_apply_matches_jax(s, name, use_kernel, xlstm):
    jcfg, jparams, cfg, tparams = xlstm
    jp, tp = _cell(jparams, tparams, "kind_mlstm")
    jx, tx = _x((2, s, cfg.d_model), 1, name)
    ref = jax.jit(lambda x: jax_ssm.mlstm_apply(x, jp, jcfg.n_heads, jcfg.ssm.chunk))(jx)
    out = ssm.mlstm_apply(tx, tp, cfg.n_heads, cfg.ssm.chunk, use_kernel=use_kernel)
    assert out.dtype == DTYPES[name][1] and out.shape == (2, s, cfg.d_model)
    assert _err(out, ref) <= TOL[name]


def test_mlstm_chunking_is_exact_in_fp32(xlstm):
    """One chunk of 64 against two of 32 and four of 16: the stabilised
    chunkwise form is the same function whatever the chunk."""
    _, _, cfg, tparams = xlstm
    tp = tparams["blocks"][0]["kind_mlstm"]
    _, tx = _x((2, 64, cfg.d_model), 2, "float32")
    outs = [ssm.mlstm_apply(tx, tp, cfg.n_heads, c) for c in (64, 32, 16)]
    for o in outs[1:]:
        assert _err(o, outs[0].numpy()) <= 2e-5


@pytest.mark.parametrize("name", list(DTYPES))
def test_mlstm_decode_matches_jax(name, xlstm):
    """12 chained steps from the initial state (m = -1e30): output and the
    three states after every step."""
    jcfg, jparams, cfg, tparams = xlstm
    jp, tp = _cell(jparams, tparams, "kind_mlstm")
    jdt, tdt = DTYPES[name]
    jx, tx = _x((2, 12, cfg.d_model), 3, name)
    jc = jax_recurrent.xlstm_init_cache(jcfg, 2, 16, jdt)[0]
    tc = recurrent.xlstm_init_cache(cfg, 2, 16, tdt, device="cpu")[0]
    jstate, tstate = (jc["c"], jc["n"], jc["m"]), (tc["c"], tc["n"], tc["m"])
    step = jax.jit(lambda x, c, n, m: jax_ssm.mlstm_decode(x, jp, jcfg.n_heads, c, n, m))
    for t in range(12):
        jy, *jstate = step(jx[:, t:t + 1], *jstate)
        ty, *tstate = ssm.mlstm_decode(tx[:, t:t + 1], tp, cfg.n_heads, *tstate)
        assert ty.dtype == tdt and _err(ty, jy) <= TOL[name], t
        for got, want in zip(tstate, jstate):
            assert got.dtype == torch.float32 and _err(got, want) <= TOL[name], t


def test_mlstm_decode_chained_matches_apply(xlstm):
    """The recurrent step, chained over 64 tokens, against the chunkwise form
    (two chunks of 32), fp32."""
    _, _, cfg, tparams = xlstm
    tp = tparams["blocks"][0]["kind_mlstm"]
    _, tx = _x((2, 64, cfg.d_model), 4, "float32")
    full = ssm.mlstm_apply(tx, tp, cfg.n_heads, 32)
    c = recurrent.xlstm_init_cache(cfg, 2, 64, torch.float32, device="cpu")[0]
    state = (c["c"], c["n"], c["m"])
    ys = []
    for t in range(64):
        y, *state = ssm.mlstm_decode(tx[:, t:t + 1], tp, cfg.n_heads, *state)
        ys.append(y)
    assert _err(torch.cat(ys, 1), full.numpy()) <= 2e-4


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_slstm_apply_matches_jax(name, use_kernel, xlstm):
    jcfg, jparams, cfg, tparams = xlstm
    jp, tp = _cell(jparams, tparams, "kind_slstm")
    jx, tx = _x((2, 24, cfg.d_model), 5, name)
    jy, jh, jc = jax.jit(lambda x: jax_ssm.slstm_apply(x, jp))(jx)
    before = matmul.launches
    ty, th, tc = ssm.slstm_apply(tx, tp, use_kernel=use_kernel)
    assert matmul.launches == before  # CPU tensors take the plain versions
    assert ty.dtype == th.dtype == DTYPES[name][1] and tc.dtype == torch.float32
    for got, want in ((ty, jy), (th, jh), (tc, jc)):
        assert _err(got, want) <= TOL[name]


def test_slstm_input_gate_is_clipped_at_zero():
    """exp(min(i, 0)): a large input gate does not blow up the cell."""
    d = 8
    p = {"w_gates": torch.zeros((d, 4 * d)), "r_gates": torch.zeros((d, 4 * d)),
         "norm": {"scale": torch.ones(d)}}
    p["w_gates"][:, :d] = 100.0  # i
    p["w_gates"][:, 2 * d:3 * d] = torch.eye(d)  # z
    x = torch.ones((1, 3, d))
    _, _, c = ssm.slstm_apply(x, p)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    _, _, jc = jax_ssm.slstm_apply(jnp.asarray(x.numpy()), jp)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    assert float(c.abs().max()) < 3.0


@pytest.mark.parametrize("s", [64, 16])
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_matches_jax(s, name, use_kernel, xlstm):
    jcfg, jparams, cfg, tparams = xlstm
    jdt, tdt = DTYPES[name]
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, s))
    ref = jax.jit(lambda p, t: jax_recurrent.xlstm_forward(p, jcfg, t, compute_dtype=jdt,
                                                           remat="none"))(jparams,
                                                                          jnp.asarray(toks))
    out = api.prefill_logits(tparams, cfg, {"tokens": torch.from_numpy(toks)},
                             compute_dtype=tdt, use_kernel=use_kernel)
    assert out.dtype == torch.float32 and out.shape == (2, s, cfg.vocab)
    assert _err(out, ref) <= TOL[name]


@pytest.mark.parametrize("name", list(DTYPES))
def test_decode_matches_jax_tick_by_tick(name, xlstm):
    """20 ticks: logits and every state of both blocks after every tick."""
    jcfg, jparams, cfg, tparams = xlstm
    jdt, tdt = DTYPES[name]
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 20))
    jcache = jax_api.init_cache(jcfg, 2, 32, dtype=jdt)
    tcache = api.init_cache(cfg, 2, 32, tdt, device="cpu")
    jstep = jax.jit(lambda c, t, p: jax_api.decode_step(jparams, jcfg, c, t, p,
                                                        compute_dtype=jdt))
    for t in range(20):
        pos = np.full((2,), t, np.int32)
        jlogits, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        with torch.inference_mode():
            logits, tcache = api.decode_step(tparams, cfg, tcache,
                                             torch.from_numpy(toks[:, t:t + 1]),
                                             torch.from_numpy(pos).long(), compute_dtype=tdt)
        assert _err(logits, jlogits) <= TOL[name], t
        for got, want in zip(tcache, jcache):
            assert got.keys() == want.keys()
            for key in got:
                assert got[key].dtype == DTYPES[str(want[key].dtype)][1], (t, key)
                assert _err(got[key], want[key]) <= TOL[name], (t, key)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_chained_matches_prefill(use_kernel, xlstm):
    """Decode, chained over 64 tokens (two chunks of the forward), against
    the forward at every position (fp32)."""
    _, _, cfg, tparams = xlstm
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (2, 64)))
    full = api.prefill_logits(tparams, cfg, {"tokens": toks}, compute_dtype=torch.float32,
                              use_kernel=use_kernel)
    cache = api.init_cache(cfg, 2, 64, torch.float32, device="cpu")
    for t in range(64):
        logits, cache = api.decode_step(tparams, cfg, cache, toks[:, t:t + 1],
                                        torch.full((2,), t), compute_dtype=torch.float32,
                                        use_kernel=use_kernel)
        assert _err(logits, full[:, t].numpy()) <= 2e-4, t


def test_loss_matches_jax(xlstm):
    jcfg, jparams, cfg, tparams = xlstm
    rng = np.random.default_rng(9)
    toks, labels = rng.integers(0, cfg.vocab, (2, 64)), rng.integers(0, cfg.vocab, (2, 64))
    ref = jax_api.loss_fn(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)},
                          compute_dtype=jnp.float32)
    loss = api.loss_fn(tparams, cfg, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)},
                       compute_dtype=torch.float32)
    assert abs(loss.item() - float(ref)) <= 2e-4 * abs(float(ref))


def test_loss_gradient_reaches_every_leaf(xlstm):
    """The remat "full" loss differentiates through both kinds of block."""
    _, _, cfg, tparams = xlstm
    leaf = transformer.map_tree(lambda t: t.detach().requires_grad_(), tparams)
    rng = np.random.default_rng(10)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}
    loss = api.loss_fn(leaf, cfg, batch, compute_dtype=torch.float32)
    leaves = jax.tree.leaves(leaf)
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert sum(bool((g != 0).any()) for g in grads) == len(grads)


def test_init_cache_matches_reference(xlstm):
    """One dict a block; the mLSTM's stabiliser starts at -1e30, not 0."""
    jcfg, _, cfg, _ = xlstm
    ref = jax_api.init_cache(jcfg, 3, 16)
    ours = api.init_cache(cfg, 3, 16, device="cpu")
    assert [sorted(c) for c in ours] == [sorted(c) for c in ref]
    for got, want in zip(ours, ref):
        for key in got:
            assert tuple(got[key].shape) == want[key].shape
            np.testing.assert_array_equal(got[key].float().numpy(),
                                          np.asarray(want[key], np.float32))
    assert bool((ours[0]["m"] == -1e30).all())


def test_param_count_is_the_mamba2_formula(xlstm):
    """The reference's fault: ``ArchConfig.param_count()`` counts an xLSTM
    block with the Mamba2 formula (the config copy keeps it), which differs
    from the weights the initialiser makes (ROADMAP.md queue 3)."""
    jcfg, jparams, cfg, _ = xlstm
    numel = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert cfg.param_count() == jcfg.param_count() != numel
    full = get_config(ARCH)
    assert full.param_count() != _xlstm_numel(full)


def _xlstm_numel(cfg) -> int:
    """The weights init_xlstm makes, counted from the shapes."""
    d, h = cfg.d_model, cfg.n_heads
    mlstm = 4 * d * d + 2 * d * h + d
    slstm = 8 * d * d + d
    n_s = sum(recurrent._is_slstm(cfg, i) for i in range(cfg.n_layers))
    return (cfg.n_layers - n_s) * (mlstm + d) + n_s * (slstm + d) + 2 * cfg.vocab * d + d
