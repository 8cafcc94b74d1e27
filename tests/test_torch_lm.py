"""The port's dense LM (repro_torch.models: layers, transformer, api) against
the JAX package's, at the reduced configs of StarCoder2-3B and
H2O-Danube-3-4B: the JAX initialiser's weights are carried across with
``params_from_jax`` and both packages get the same numpy tokens. On the
CPU every kernel of the port takes its plain version; the JAX side runs
its Pallas flash attention in interpret mode through the ``attn_fn`` hook
where the port's ``use_kernel=True`` route takes the flash kernel."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_attention.ops import attn_fn as jax_attn_fn  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import api, layers, transformer  # noqa: E402

ARCHS = ["starcoder2-3b", "h2o-danube-3-4b"]
# configs copied later (ROADMAP.md queue 1 item 4): nemotron's squared-ReLU
# MLP and llava's projector run at their reduced sizes
COPIED = ["nemotron-4-340b", "starcoder2-15b", "llava-next-34b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # normalised: max|d| / max|ref|
SEQ = 96  # past Danube's reduced window of 64


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
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("arch", ARCHS + COPIED)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(arch, reduced):
    ours, ref = get_config(arch), jax_get_config(arch)
    if reduced:
        ours, ref = ours.reduced(), ref.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.head_dim, ours.param_count(), ours.sub_quadratic) == \
        (ref.head_dim, ref.param_count(), ref.sub_quadratic)


def test_unported_arch_names_its_roadmap_item():
    """Every architecture of the JAX registry is ported, in its order; an
    unknown one raises KeyError naming the known ones."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    assert ARCH_IDS == JAX_ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax(arch, models):
    jcfg, jparams, cfg, tparams = models(arch)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(jax.tree.leaves(tparams))
    for path, leaf in flat:
        t = tparams
        for key in path:
            t = t[key.key]
        assert t.shape == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert tparams["blocks"]["attn"]["wq"].shape[0] == cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS + COPIED[:2])
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_matches_jax(arch, name, use_kernel, models):
    jcfg, jparams, cfg, tparams = models(arch)
    jdt, tdt = DTYPES[name]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, SEQ))
    ref = jax_transformer.forward(jparams, jcfg, jnp.asarray(toks), compute_dtype=jdt,
                                  remat="none", attn_fn=jax_attn_fn if use_kernel else None)
    out = api.prefill_logits(tparams, cfg, {"tokens": torch.from_numpy(toks)},
                             compute_dtype=tdt, use_kernel=use_kernel)
    assert out.dtype == torch.float32 and out.shape == (2, SEQ, cfg.vocab)
    assert _err(out.numpy(), ref) <= TOL[name]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(DTYPES))
def test_decode_matches_jax_tick_by_tick(arch, name, models):
    """80 ticks, so that Danube's 64-slot ring buffer wraps; logits and both
    caches after every tick."""
    jcfg, jparams, cfg, tparams = models(arch)
    jdt, tdt = DTYPES[name]
    ticks, batch = 80, 2
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (batch, ticks))
    jcache = jax_api.init_cache(jcfg, batch, 96, dtype=jdt)
    tcache = api.init_cache(cfg, batch, 96, tdt, device="cpu")
    assert tcache["k"].shape == jcache["k"].shape
    jstep = jax.jit(lambda c, t, p: jax_api.decode_step(jparams, jcfg, c, t, p,
                                                        compute_dtype=jdt))
    for t in range(ticks):
        pos = np.full((batch,), t, np.int32)
        jlogits, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        with torch.inference_mode():
            logits, tcache = api.decode_step(tparams, cfg, tcache,
                                             torch.from_numpy(toks[:, t:t + 1]),
                                             torch.from_numpy(pos).long(), compute_dtype=tdt)
        assert _err(logits.numpy(), jlogits) <= TOL[name], t
        for key in ("k", "v"):
            assert tcache[key].dtype == tdt
            assert _err(tcache[key].float().numpy(), jcache[key]) <= TOL[name], (t, key)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_vlm_prefill_matches_jax(name, use_kernel, models):
    """llava-next-34b: patch embeddings projected and prepended to the text
    embeddings; logits over patches and text."""
    jcfg, jparams, cfg, tparams = models("llava-next-34b")
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 24))
    patches = rng.standard_normal((2, cfg.n_patches, cfg.vision_embed_dim)).astype(np.float32)
    ref = jax_transformer.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(patches),
                                  compute_dtype=jdt, remat="none",
                                  attn_fn=jax_attn_fn if use_kernel else None)
    out = api.prefill_logits(tparams, cfg, {"tokens": torch.from_numpy(toks),
                                            "patch_embeds": torch.from_numpy(patches)},
                             compute_dtype=tdt, use_kernel=use_kernel)
    assert out.shape == (2, cfg.n_patches + 24, cfg.vocab) and out.dtype == torch.float32
    assert _err(out.numpy(), ref) <= TOL[name]


def test_vlm_decode_matches_jax(models):
    """The VLM decodes text as the dense LM does (api's "vlm" branches): 6
    ticks, logits and caches, fp32."""
    jcfg, jparams, cfg, tparams = models("llava-next-34b")
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 6))
    jcache = jax_api.init_cache(jcfg, 2, 8, dtype=jnp.float32)
    tcache = api.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    for t in range(6):
        pos = np.full((2,), t, np.int32)
        jlogits, jcache = jax_api.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]),
                                              jnp.asarray(pos), compute_dtype=jnp.float32)
        with torch.inference_mode():
            logits, tcache = api.decode_step(tparams, cfg, tcache,
                                             torch.from_numpy(toks[:, t:t + 1]),
                                             torch.from_numpy(pos).long(),
                                             compute_dtype=torch.float32)
        assert _err(logits.numpy(), jlogits) <= TOL["float32"], t
        for key in ("k", "v"):
            assert _err(tcache[key].numpy(), jcache[key]) <= TOL["float32"], (t, key)


@pytest.mark.parametrize("name", list(DTYPES))
def test_layer_norm_matches_jax(name):
    from repro.models import layers as jax_layers
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 5, 96)) * 4 + 1.5).astype(np.float32)
    params = {"scale": rng.standard_normal(96).astype(np.float32),
              "bias": rng.standard_normal(96).astype(np.float32)}
    ref = jax_layers.layer_norm(jnp.asarray(x, jdt), jax.tree.map(jnp.asarray, params))
    out = layers.layer_norm(torch.from_numpy(x).to(tdt),
                            {k: torch.from_numpy(v) for k, v in params.items()})
    assert out.dtype == tdt
    assert _err(out.float().numpy(), np.asarray(ref, np.float32)) <= TOL[name]
    init = layers.init_layernorm(96, device="cpu")
    assert jax.tree.map(np.asarray, jax_layers.init_layernorm(96)).keys() == init.keys()
    assert torch.equal(init["scale"], torch.ones(96)) and torch.equal(init["bias"], torch.zeros(96))


def test_decode_past_cache_end_matches_jax(models):
    """A decode step at a position past the cache (pos 4 of s_max = 4): the
    reference's one-hot drops the write and still returns logits; the port
    builds the same mask (ROADMAP queue 3, fault 6). fp32 at 2e-4, logits
    and both caches after every step."""
    jcfg, jparams, cfg, tparams = models("starcoder2-3b")
    s_max, steps = 4, 5
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, steps))
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
        assert _err(logits.numpy(), jlogits) <= 2e-4, t
        for key in ("k", "v"):
            assert _err(new[key].numpy(), jcache[key]) <= 2e-4, (t, key)
            if t >= s_max:  # the write past the cache is dropped
                assert torch.equal(new[key], tcache[key]), (t, key)
        tcache = new


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_matches_prefill_last_token(arch, use_kernel, models):
    """tests/test_arch_smoke.py::test_decode_matches_prefill_last_token, on the port."""
    _, _, cfg, tparams = models(arch)
    seq = 8
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (1, seq)))
    full = api.prefill_logits(tparams, cfg, {"tokens": toks}, compute_dtype=torch.float32,
                              use_kernel=use_kernel)
    cache = api.init_cache(cfg, 1, seq, torch.float32, device="cpu")
    logits = None
    for t in range(seq):
        logits, cache = api.decode_step(tparams, cfg, cache, toks[:, t:t + 1],
                                        torch.tensor([t]), compute_dtype=torch.float32,
                                        use_kernel=use_kernel)
    torch.testing.assert_close(logits, full[:, -1], atol=2e-2, rtol=2e-2)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = get_config("starcoder2-3b").reduced()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_lm(cfg, generator=gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(cfg, generator=gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.params_from_jax({"w": np.zeros(2, np.float32)})


@pytest.mark.parametrize("arch", ARCHS + COPIED[2:])
def test_init_lm_matches_reference_tree(arch, models):
    """The port's own initialiser gives the JAX tree's structure, shapes and
    scales (the values differ: torch.Generator is not jax.random)."""
    jcfg, jparams, cfg, tparams = models(arch)
    ours = transformer.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                               dtype=torch.bfloat16)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(ours) == shapes(jparams)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(ours))
    wq = ours["blocks"]["attn"]["wq"].float()
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(ours["embed"].float().std().item() / 0.02 - 1.0) < 0.05


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to approximate=True; the port's mlp matches it,
    not the exact (erf) GELU."""
    x = torch.linspace(-4, 4, 101)
    params = {"w_up": torch.eye(101), "w_down": torch.eye(101)}
    out = layers.mlp(x[None], params, "gelu")[0]
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
    assert (out - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def test_silu_rounds_as_jax():
    """Compiled, jax.nn.silu rounds each of x * (1 / (1 + exp(-x))) to bf16;
    layers.silu does the same, F.silu rounds once."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 3
    ref = np.asarray(jax.jit(jax.nn.silu)(jnp.asarray(x, jnp.bfloat16)), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ours = layers.silu(xt).float().numpy()
    assert (ours != ref).mean() < 0.01
    assert (torch.nn.functional.silu(xt).float().numpy() != ref).mean() > 0.2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_resolves_and_builds_a_cache(arch):
    """Each arch id resolves in the registry to the reference's config, and
    api.init_cache builds the reference's cache structure and shapes at its
    reduced size."""
    from repro.configs import get_config as jax_cfg
    cfg = get_config(arch).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg(arch).reduced())
    ours = api.init_cache(cfg, 2, 8, device="cpu")
    ref = jax_api.init_cache(jax_cfg(arch).reduced(), 2, 8)
    shapes = lambda tree: [(tuple(a.shape), str(a.dtype).removeprefix("torch."))  # noqa: E731
                           for a in jax.tree.leaves(tree)]
    assert jax.tree.structure(jax.tree.map(lambda a: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, ref))
    assert shapes(ours) == shapes(ref)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "h2o-danube-3-4b", "--batch", "2", "--prompt-len", "3", "--gen", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "h2o-danube-3-4b: served 2 seqs x (3 prompt + 2 generated) = 10 steps" in out
    assert "seq1:" in out
