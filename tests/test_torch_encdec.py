"""The port's Whisper encoder-decoder (repro_torch.models.encdec, api's
"audio" family) against the JAX package's, at
``get_config("whisper-base").reduced()`` (2 + 2 layers, d 128, 4 heads of
32, 64 frames): the JAX initialiser's weights are carried across with
``params_from_jax`` and both packages get the same numpy frames and tokens.
On the CPU the port's kernel wrappers take their plain versions; the JAX
side's reference route has no ``attn_fn`` in the encoder (its ``forward``
passes none) nor in the cross-attention (it takes none), so the port's
``use_kernel`` route is held to JAX's plain route. fp32 at 2e-4, bf16 at
2e-2 (normalised max|d| / max|ref|)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_attention.ops import attn_fn as jax_attn_fn  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.models import api, encdec, transformer  # noqa: E402

ARCH = "whisper-base"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def whisper():
    jcfg = jax_get_config(ARCH).reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config(ARCH).reduced(), tparams


def _err(out, ref) -> float:
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _inputs(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab, (b, s))


def test_sinusoids_match_jax():
    np.testing.assert_allclose(encdec.sinusoids(100, 64).numpy(),
                               np.asarray(jax_encdec.sinusoids(100, 64)), rtol=1e-5, atol=1e-5)


def test_init_encdec_matches_reference_tree(whisper):
    jcfg, jparams, cfg, tparams = whisper
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(jax.tree.leaves(tparams))
    ours = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.bfloat16)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(ours) == shapes(jparams)
    assert abs(ours["pos_dec"].float().std().item() / 0.01 - 1.0) < 0.05


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_encode_matches_jax(name, use_kernel, whisper):
    jcfg, jparams, cfg, tparams = whisper
    jdt, tdt = DTYPES[name]
    frames, _ = _inputs(cfg)
    ref = jax.jit(lambda p, f: jax_encdec.encode(p, jcfg, f, compute_dtype=jdt))(
        jparams, jnp.asarray(frames))
    out = encdec.encode(tparams, cfg, torch.from_numpy(frames), compute_dtype=tdt,
                        use_kernel=use_kernel)
    assert out.dtype == tdt and out.shape == frames.shape
    assert _err(out, ref) <= TOL[name]


def test_encode_kernel_route_matches_jax_flash(whisper):
    """The encoder with JAX's Pallas flash attention (interpret mode) through
    its ``attn_fn`` hook, against the port's kernel route, fp32."""
    jcfg, jparams, cfg, tparams = whisper
    frames, _ = _inputs(cfg, seed=1)
    ref = jax_encdec.encode(jparams, jcfg, jnp.asarray(frames), compute_dtype=jnp.float32,
                            attn_fn=jax_attn_fn)
    out = encdec.encode(tparams, cfg, torch.from_numpy(frames), compute_dtype=torch.float32)
    assert _err(out, ref) <= 2e-4


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_train_matches_jax(name, use_kernel, whisper):
    """The teacher-forced decoder on the same encoder output (JAX's)."""
    jcfg, jparams, cfg, tparams = whisper
    jdt, tdt = DTYPES[name]
    frames, toks = _inputs(cfg)
    memory = jax_encdec.encode(jparams, jcfg, jnp.asarray(frames), compute_dtype=jdt)
    ref = jax.jit(lambda p, t, m: jax_encdec.decode_train(p, jcfg, t, m, compute_dtype=jdt,
                                                          remat="none"))(
        jparams, jnp.asarray(toks), memory)
    tmem = torch.from_numpy(np.array(memory, np.float32)).to(tdt)
    out = encdec.decode_train(tparams, cfg, torch.from_numpy(toks), tmem, compute_dtype=tdt,
                              use_kernel=use_kernel)
    assert out.dtype == torch.float32 and out.shape == (2, 12, cfg.vocab)
    assert _err(out, ref) <= TOL[name]


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_matches_jax(name, use_kernel, whisper):
    """api.prefill_logits (encode + decode_train) against JAX's."""
    jcfg, jparams, cfg, tparams = whisper
    jdt, tdt = DTYPES[name]
    frames, toks = _inputs(cfg, seed=2)
    ref = jax_api.prefill_logits(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                                 "frames": jnp.asarray(frames)},
                                 compute_dtype=jdt, remat="none")
    before = flash_attention.launches
    out = api.prefill_logits(tparams, cfg, {"tokens": torch.from_numpy(toks),
                                            "frames": torch.from_numpy(frames)},
                             compute_dtype=tdt, use_kernel=use_kernel)
    assert flash_attention.launches == before  # CPU tensors take the plain versions
    assert _err(out, ref) <= TOL[name]


def test_prefill_cross_matches_jax(whisper):
    jcfg, jparams, cfg, tparams = whisper
    frames, _ = _inputs(cfg, b=1, seed=3)
    memory = jax_encdec.encode(jparams, jcfg, jnp.asarray(frames), compute_dtype=jnp.float32)
    jcache = jax_encdec.prefill_cross(
        jparams, jcfg, memory, jax_encdec.init_cache(jcfg, 1, 8, cfg.n_audio_frames,
                                                     dtype=jnp.float32))
    tcache = api.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    tmem = torch.from_numpy(np.array(memory))
    new = encdec.prefill_cross(tparams, cfg, tmem, tcache)
    assert (tcache["xk"] == 0).all()  # the cache passed in is not changed
    for key in ("xk", "xv"):
        assert _err(new[key], jcache[key]) <= 2e-4


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_matches_teacher_forcing(use_kernel, whisper):
    """tests/test_encdec_consistency.py on the port: prefill_cross + 8 decode
    steps against decode_train at every position (fp32), and each step's
    logits against JAX's decode_step on the same cache."""
    jcfg, jparams, cfg, tparams = whisper
    frames, toks = _inputs(cfg, b=1, s=8, seed=4)
    tmem = encdec.encode(tparams, cfg, torch.from_numpy(frames), compute_dtype=torch.float32,
                         use_kernel=use_kernel)
    full = encdec.decode_train(tparams, cfg, torch.from_numpy(toks), tmem,
                               compute_dtype=torch.float32, use_kernel=use_kernel)
    cache = encdec.prefill_cross(tparams, cfg, tmem,
                                 api.init_cache(cfg, 1, 8, torch.float32, device="cpu"),
                                 use_kernel=use_kernel)
    jcache = jax_encdec.prefill_cross(jparams, jcfg, jnp.asarray(tmem.numpy()),
                                      jax_encdec.init_cache(jcfg, 1, 8, cfg.n_audio_frames,
                                                            dtype=jnp.float32))
    jstep = jax.jit(lambda c, t, p: jax_api.decode_step(jparams, jcfg, c, t, p,
                                                        compute_dtype=jnp.float32))
    for t in range(8):
        pos = np.array([t], np.int32)
        jlogits, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        logits, cache = api.decode_step(tparams, cfg, cache, torch.from_numpy(toks[:, t:t + 1]),
                                        torch.from_numpy(pos).long(),
                                        compute_dtype=torch.float32, use_kernel=use_kernel)
        assert _err(logits, full[:, t].numpy()) <= 2e-4, t
        assert _err(logits, jlogits) <= 2e-4, t
        for key in ("k", "v"):
            assert _err(cache[key], jcache[key]) <= 2e-4, (t, key)


def test_decode_bf16_matches_jax(whisper):
    """8 bf16 decode steps on a bf16 cache against JAX's, logits at 2e-2."""
    jcfg, jparams, cfg, tparams = whisper
    frames, toks = _inputs(cfg, b=2, s=8, seed=5)
    jmem = jax_encdec.encode(jparams, jcfg, jnp.asarray(frames))
    jcache = jax_encdec.prefill_cross(jparams, jcfg, jmem,
                                      jax_api.init_cache(jcfg, 2, 8, dtype=jnp.bfloat16))
    tmem = torch.from_numpy(np.array(jmem, np.float32)).to(torch.bfloat16)
    cache = encdec.prefill_cross(tparams, cfg, tmem, api.init_cache(cfg, 2, 8, device="cpu"))
    jstep = jax.jit(lambda c, t, p: jax_api.decode_step(jparams, jcfg, c, t, p))
    for t in range(8):
        pos = np.full((2,), t, np.int32)
        jlogits, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        logits, cache = api.decode_step(tparams, cfg, cache, torch.from_numpy(toks[:, t:t + 1]),
                                        torch.from_numpy(pos).long())
        assert _err(logits, jlogits) <= 2e-2, t


def test_loss_matches_jax(whisper):
    jcfg, jparams, cfg, tparams = whisper
    frames, toks = _inputs(cfg, seed=6)
    labels = np.roll(toks, -1, axis=1)
    ref = jax_api.loss_fn(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels),
                                          "frames": jnp.asarray(frames)},
                          compute_dtype=jnp.float32)
    loss = api.loss_fn(tparams, cfg, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels),
                                      "frames": torch.from_numpy(frames)},
                       compute_dtype=torch.float32)
    assert abs(loss.item() - float(ref)) <= 2e-4 * abs(float(ref))


def test_encoder_is_order_sensitive(whisper):
    """tests/test_encdec_consistency.py::test_whisper_encoder_is_order_sensitive
    on the port's kernel route: the encoder attends across frames."""
    _, _, cfg, tparams = whisper
    frames, _ = _inputs(cfg, b=1, seed=7)
    f = torch.from_numpy(frames)
    m1 = encdec.encode(tparams, cfg, f, compute_dtype=torch.float32)
    m2 = encdec.encode(tparams, cfg, f.flip(1), compute_dtype=torch.float32)
    assert not torch.allclose(m1, m2)


def test_jax_forward_drops_attn_fn_for_the_encoder(whisper, monkeypatch):
    """The reference's fault (ROADMAP.md queue 3): ``encdec.forward`` passes
    the caller's ``attn_fn`` to the decoder only; the encoder and the
    cross-attention run the plain attention whatever the caller asks."""
    jcfg, jparams, cfg, _ = whisper
    frames, toks = _inputs(cfg, b=1, s=4, seed=8)
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal")))
        return jax_attn_fn(q, k, v, **kw)

    jax_encdec.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(frames),
                       compute_dtype=jnp.float32, remat="none", attn_fn=spy, unroll=True)
    assert calls and all(c == (4, 4, True) for c in calls)  # decoder self-attention only
