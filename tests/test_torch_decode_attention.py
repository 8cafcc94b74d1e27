"""Decode attention on a KV cache updated in place
(repro_torch.kernels.decode_attention) and the donated decode step that
takes it.

On the CPU the wrappers take their plain in-place versions (``ref``): they
are held to the blend-and-masked-softmax path of
``layers.gqa_decode_attention`` (the non-donated one), the donated
``decode_step`` to the non-donated one and to JAX's, and the batcher, which
donates its cache, to one that does not. The CUDA kernels themselves are
checked by the ``cuda``-marked cases, against ``ref`` at the serving cell's
tick shape."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as launcher  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (decode_attend, rope_append,  # noqa: E402
                                                      rope_table, takes)
from repro_torch.kernels.decode_attention.ref import (decode_attend_ref,  # noqa: E402
                                                      rope_append_ref)
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.serve import scheduler  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(name):  # tests/test_kernels.py::_tol
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-4, rtol=2e-4)


def _tick(b, s, h, kv, hd, dtype, seed=0, device="cpu"):
    """The tick's products q (B, 1, H*hd), k, v (B, 1, KV*hd) and a filled
    cache pair (B, S, KV, hd), from a seeded generator."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(device=device, dtype=dtype)

    return rnd(b, 1, h * hd), rnd(b, 1, kv * hd), rnd(b, 1, kv * hd), rnd(b, s, kv, hd), \
        rnd(b, s, kv, hd)


# ---------------------------------------------------------------------------
# The plain in-place path against the blend and the masked softmax
# ---------------------------------------------------------------------------

S_SLOTS = 16
# (write_pos, valid_upto) a slot: the first position, mid-cache, the full
# ring (valid S - 1, as decode_step passes a wrapped ring), a write past the
# ring (dropped; a cache without a window attends every position there)
LAYER_CASES = {
    "first": ([0, 0, 0], [0, 0, 0]),
    "mid": ([7, 3, 11], [7, 3, 11]),
    "full_ring": ([5, 15, 0], [15, 15, 15]),
    "past_ring": ([16, 20, 4], [16, 20, 4]),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_donated_layer_matches_blend_and_masked_softmax(case):
    """``gqa_decode_attention(donate=True)`` (rope_append_ref and
    decode_attend_ref, in place) against the non-donated blend and masked
    softmax, fp32: the output at 2e-4, the caches bit-equal, the rows other
    than the written ones untouched, a write past the ring dropped."""
    b, h, kv, hd, d = 3, 8, 2, 32, 64
    gen = torch.Generator().manual_seed(3)
    params = layers.init_attention(gen, d, h, kv, hd)
    x = torch.randn((b, 1, d), generator=gen)
    _, _, _, kc, vc = _tick(b, S_SLOTS, h, kv, hd, torch.float32, seed=1)
    write_pos, valid = (torch.tensor(p) for p in LAYER_CASES[case])
    rope_pos = write_pos + 100
    kw = dict(rope_pos=rope_pos, valid_upto=valid, rope_theta=999999.44, use_kernel=True)
    out, k_new, v_new = layers.gqa_decode_attention(x, params, h, kv, kc, vc, write_pos, **kw)
    k0, v0 = kc.clone(), vc.clone()
    out_d, k_d, v_d = layers.gqa_decode_attention(x, params, h, kv, kc, vc, write_pos,
                                                  donate=True, **kw)
    assert k_d is kc and v_d is vc
    torch.testing.assert_close(out_d, out, atol=2e-4, rtol=2e-4)
    assert torch.equal(kc, k_new) and torch.equal(vc, v_new)
    for i, p in enumerate(write_pos.tolist()):
        others = torch.ones(S_SLOTS, dtype=torch.bool)
        if 0 <= p < S_SLOTS:
            others[p] = False
            assert not torch.equal(kc[i, p], k0[i, p])
        assert torch.equal(kc[i, others], k0[i, others]) and \
            torch.equal(vc[i, others], v0[i, others])


def test_rope_append_ref_rotates_as_apply_rope():
    """q and the written k are ``apply_rope``'s, bit for bit; v is copied."""
    b, s, h, kv, hd = 2, 8, 4, 2, 32
    q, k, v, kc, vc = _tick(b, s, h, kv, hd, torch.float32)
    write_pos, rope_pos = torch.tensor([3, 6]), torch.tensor([3, 4099])
    q_rot = rope_append(q, k, v, kc, vc, write_pos, rope_pos, 10000.0)
    want_q = layers.apply_rope(q.reshape(b, 1, h, hd), rope_pos[:, None], 10000.0)
    want_k = layers.apply_rope(k.reshape(b, 1, kv, hd), rope_pos[:, None], 10000.0)
    assert torch.equal(q_rot, want_q.reshape(b, 1, h * hd))
    for i, p in enumerate(write_pos.tolist()):
        assert torch.equal(kc[i, p], want_k[i, 0])
        assert torch.equal(vc[i, p], v.reshape(b, kv, hd)[i])
    no_rot = rope_append(q, k, v, kc, vc, write_pos, rope_pos, None)
    assert torch.equal(no_rot, q) and torch.equal(kc[0, 3], k.reshape(b, kv, hd)[0])


def test_rope_table_is_rope_freqs():
    for hd, theta in ((32, 10000.0), (128, 999999.44)):
        assert torch.equal(rope_table(hd, theta, torch.device("cpu")),
                           layers.rope_freqs(hd, theta))


def test_decode_attend_ref_without_valid_position_is_nan():
    """valid_upto < 0 attends no position: NaN, as the masked softmax gives."""
    q, _, _, kc, vc = _tick(2, 8, 4, 2, 16, torch.float32)
    out = decode_attend_ref(q, kc, vc, torch.tensor([-1, 3]))
    assert bool(out[0].isnan().all()) and bool(out[1].isfinite().all())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, kc, vc = _tick(2, 8, 4, 2, 16, torch.float32)
    pos = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="int64"):
        decode_attend(q, kc, vc, pos.int())
    with pytest.raises(ValueError, match="one for q and the caches"):
        decode_attend(q.bfloat16(), kc, vc, pos)
    with pytest.raises(ValueError, match="limits"):
        decode_attend(*_tick(2, 8, 4, 2, 12, torch.float32)[:1], *_tick(2, 8, 4, 2, 12,
                                                                          torch.float32)[3:],
                      pos)
    with pytest.raises(ValueError, match="takes k, v"):
        rope_append(q, k[:, :, :8], v, kc, vc, pos, pos, 10000.0)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attend(q, kc.transpose(1, 2).contiguous().transpose(1, 2), vc, pos)
    assert takes(kc, vc, torch.float32, 4) and not takes(kc, vc, torch.bfloat16, 4)
    assert not takes(kc, vc, torch.float32, 3) and not takes(kc[:, :, :, :12], vc[:, :, :, :12],
                                                             torch.float32, 4)


def test_plan_routes():
    """The cell's tick (64 slots x 4096, 2 KV heads of 128) in bf16 takes the
    tensor cores in chunks of 4 tiles; fp32, hd % 16 == 8 and hd > 128 the
    CUDA cores; a small grid takes shorter chunks, down to one tile."""
    P = launcher.Plan
    assert launcher.plan(64, 4096, 2, 128, torch.bfloat16) == P("mma", 256)
    assert launcher.plan(64, 4096, 2, 128, torch.float32) == P("simt", 128)
    assert launcher.plan(64, 4096, 8, 120, torch.bfloat16) == P("simt", 256)
    assert launcher.plan(64, 4096, 8, 192, torch.bfloat16) == P("simt", 256)
    assert launcher.plan(2, 200, 2, 128, torch.bfloat16) == P("mma", 64)
    assert launcher.plan(1, 4096, 2, 32, torch.float32) == P("simt", 32)


# ---------------------------------------------------------------------------
# The donated decode step and the batcher
# ---------------------------------------------------------------------------


def _lm(arch="starcoder2-3b"):
    cfg = get_config(arch).reduced()
    return cfg, api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("arch", ["starcoder2-3b", "h2o-danube-3-4b"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_donated_decode_step_equals_the_functional_one(arch, name):
    """80 ticks (Danube's 64-slot ring wraps; StarCoder2's third slot writes
    past its 70 positions): logits and caches bit-equal to the non-donated
    step's, the donated cache updated in place and returned."""
    cfg, params = _lm(arch)
    dt = DTYPES[name]
    ref = api.init_cache(cfg, 3, 70, dt, device="cpu")
    cache = {key: t.clone() for key, t in ref.items()}
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (3, 80)))
    for t in range(80):
        pos = torch.tensor([t, max(t - 9, 0), t + 3])
        with torch.inference_mode():
            want, ref = api.decode_step(params, cfg, ref, toks[:, t:t + 1], pos,
                                        compute_dtype=dt)
            got, out = api.decode_step(params, cfg, cache, toks[:, t:t + 1], pos,
                                       compute_dtype=dt, donate=True)
        assert out is cache
        assert torch.equal(got, want), t
        assert torch.equal(cache["k"], ref["k"]) and torch.equal(cache["v"], ref["v"]), t


def test_donation_keeps_todays_path_where_it_does_not_apply():
    """``use_kernel=False``, a cache in another dtype than the compute and a
    family other than dense/VLM take the functional step: a new cache, the
    one passed in unchanged."""
    cfg, params = _lm()
    toks, pos = torch.tensor([[3], [5]]), torch.tensor([0, 4])
    for dt, kw in ((torch.bfloat16, dict(use_kernel=False)),
                   (torch.bfloat16, dict(compute_dtype=torch.float32))):
        cache = api.init_cache(cfg, 2, 8, dt, device="cpu")
        before = {key: t.clone() for key, t in cache.items()}
        _, new = api.decode_step(params, cfg, cache, toks, pos, donate=True, **kw)
        assert new is not cache and all(torch.equal(cache[key], before[key]) for key in cache)
    mcfg = get_config("kimi-k2-1t-a32b").reduced()
    mparams = api.init_params(mcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    cache = api.init_cache(mcfg, 2, 8, torch.float32, device="cpu")
    before = {key: t.clone() for key, t in cache.items()}
    with torch.inference_mode():
        _, new = api.decode_step(mparams, mcfg, cache, toks, pos, donate=True,
                                 compute_dtype=torch.float32)
    assert new is not cache and all(torch.equal(cache[key], before[key]) for key in cache)


@pytest.fixture
def jax():
    """JAX is imported here, not at the top: the machine with the card has
    none, and the ``cuda`` cases below must still run there."""
    return pytest.importorskip("jax")


def test_donated_decode_step_matches_jax(jax):
    """StarCoder2 reduced, fp32, 12 ticks of two slots at other positions:
    the donated step's logits and caches within 2e-4 (normalised) of JAX's
    ``decode_step`` fed the same weights."""
    from repro.configs import get_config as jax_get_config
    from repro.models import api as jax_api
    from repro_torch.models import transformer
    jnp = jax.numpy
    jcfg = jax_get_config("starcoder2-3b").reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    cfg = get_config("starcoder2-3b").reduced()
    tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12))
    jcache = jax_api.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    cache = api.init_cache(cfg, 2, 32, torch.float32, device="cpu")

    def err(out, ref):
        out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
        return float(np.abs(out - ref).max() / np.abs(ref).max())

    for t in range(12):
        pos = np.array([t, t + 5], np.int32)
        jlogits, jcache = jax_api.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]),
                                              jnp.asarray(pos), compute_dtype=jnp.float32)
        with torch.inference_mode():
            logits, cache = api.decode_step(tparams, cfg, cache, torch.from_numpy(toks[:, t:t + 1]),
                                            torch.from_numpy(pos).long(),
                                            compute_dtype=torch.float32, donate=True)
        assert err(logits.numpy(), jlogits) <= 2e-4, t
        for key in ("k", "v"):
            assert err(cache[key].numpy(), jcache[key]) <= 2e-4, (t, key)


class _NoDonation(scheduler.ContinuousBatcher):
    def _decode(self, toks, pos):
        with torch.inference_mode():
            return api.decode_step(self.params, self.cfg, self.cache, toks, pos,
                                   use_kernel=self.use_kernel)


def test_batcher_tokens_equal_with_and_without_donation():
    """The tiny LM's batcher (bf16, 2 slots reused by 5 requests) emits the
    same tokens, ticks and utilization whether it donates its cache or not;
    the donating one keeps one cache tensor throughout."""
    cfg, params = _lm()
    rng = np.random.default_rng(0)
    reqs = [dict(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab, 5 + i)], max_new=4)
            for i in range(5)]
    runs = []
    for cls in (scheduler.ContinuousBatcher, _NoDonation):
        b = cls(cfg, params, slots=2, max_seq=64, device="cpu")
        k0 = b.cache["k"]
        for r in reqs:
            b.submit(scheduler.Request(**r))
        done = b.run()
        runs.append(([(c.rid, c.tokens) for c in done], b.steps, b.utilization,
                     b.cache["k"] is k0))
    assert runs[0][:3] == runs[1][:3]
    assert runs[0][3] and not runs[1][3]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# The serving cell's tick: 64 slots of 4096 positions, StarCoder2-3B's 24
# heads on 2 KV heads of 128.
CELL = dict(b=64, s=4096, h=24, kv=2, hd=128)
# Other shapes of the port's configurations (Danube's hd 120, Nemotron's 192,
# LLaVA's 7 heads a group) and both routes: (b, s, h, kv, hd).
SMALL = [(4, 30, 8, 2, 32), (3, 100, 8, 2, 32), (2, 300, 32, 8, 120), (2, 700, 24, 2, 192),
         (2, 200, 56, 8, 128), (1, 4096, 16, 1, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _positions(b, s, length, device):
    """write_pos and valid_upto: every slot at ``length`` positions but for
    a few at other lengths, and slot 0 writing past the ring (its write is
    dropped; it attends the whole cache)."""
    valid = torch.full((b,), length - 1, dtype=torch.long)
    valid[1::7] = torch.arange(1, b, 7) % length
    write = valid.clone()
    write[0], valid[0] = s, s - 1
    return write.to(device), valid.to(device)


def _against_ref(b, s, h, kv, hd, name, write, valid, device, seed=0):
    dtype = DTYPES[name]
    q, k, v, kc, vc = _tick(b, s, h, kv, hd, dtype, seed, device)
    rope_pos = write + 17
    kr, vr = kc.clone(), vc.clone()
    before = (rope_append.launches, decode_attend.launches)
    q_rot = rope_append(q, k, v, kc, vc, write, rope_pos, 999999.44)
    out = decode_attend(q_rot, kc, vc, valid)
    torch.cuda.synchronize()
    assert (rope_append.launches, decode_attend.launches) == (before[0] + 1, before[1] + 1)
    q_ref = rope_append_ref(q, k, v, kr, vr, write, rope_pos, rope_table(hd, 999999.44, device))
    torch.testing.assert_close(q_rot.float(), q_ref.float(), **_tol(name))
    torch.testing.assert_close(kc.float(), kr.float(), **_tol(name))
    assert torch.equal(vc, vr)
    written = torch.zeros((b, s), dtype=torch.bool, device=device)
    ok = (write >= 0) & (write < s)
    written[torch.arange(b, device=device)[ok], write[ok]] = True
    assert torch.equal(kc[~written], kr[~written])  # every other row bit-equal
    ref = decode_attend_ref(q_rot, kc, vc, valid)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(name))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 505, 2048, 4096])
@pytest.mark.parametrize("name", list(DTYPES))
def test_kernels_match_ref_at_the_cell_tick_on_card(length, name, cuda_device):
    c = CELL
    write, valid = _positions(c["b"], c["s"], length, cuda_device)
    _against_ref(c["b"], c["s"], c["h"], c["kv"], c["hd"], name, write, valid, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SMALL)
@pytest.mark.parametrize("name", list(DTYPES))
def test_kernels_match_ref_at_other_heads_on_card(shape, name, cuda_device):
    b, s, h, kv, hd = shape
    write, valid = _positions(b, s, min(s, 77), cuda_device)
    _against_ref(b, s, h, kv, hd, name, write, valid, cuda_device, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_decode_attend_deterministic_on_card(name, cuda_device):
    c = CELL
    q, _, _, kc, vc = _tick(c["b"], c["s"], c["h"], c["kv"], c["hd"], DTYPES[name], 2,
                            cuda_device)
    _, valid = _positions(c["b"], c["s"], 2048, cuda_device)
    assert torch.equal(decode_attend(q, kc, vc, valid), decode_attend(q, kc, vc, valid))


@pytest.mark.cuda
def test_kernels_captured_in_a_cuda_graph_on_card(cuda_device):
    """One rope_append and decode_attend captured, replayed with new
    write_pos, rope_pos and valid_upto copied into the captured tensors:
    the replay equals a fresh eager call (neither wrapper syncs, or the
    capture would fail)."""
    c = CELL
    q, k, v, kc, vc = _tick(c["b"], c["s"], c["h"], c["kv"], c["hd"], torch.bfloat16, 3,
                            cuda_device)
    write, valid = _positions(c["b"], c["s"], 300, cuda_device)
    rope_pos = write.clone()
    for _ in range(2):  # warm-up: plans, libraries, the shared-memory opt-in
        decode_attend(rope_append(q, k, v, kc, vc, write, rope_pos, 1e4), kc, vc, valid)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attend(rope_append(q, k, v, kc, vc, write, rope_pos, 1e4), kc, vc, valid)
    new_write, new_valid = _positions(c["b"], c["s"], 1000, cuda_device)
    write.copy_(new_write)
    valid.copy_(new_valid)
    rope_pos.copy_(new_write + 3)
    kr, vr = kc.clone(), vc.clone()
    graph.replay()
    torch.cuda.synchronize()
    want = decode_attend(rope_append(q, k, v, kr, vr, write, rope_pos, 1e4), kr, vr, valid)
    assert torch.equal(kc, kr) and torch.equal(vc, vr) and torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_donated_tick_launches_each_kernel_once_a_layer_on_card(name, cuda_device):
    """StarCoder2-3B reduced to its 30 layers' depth: a donated tick launches
    rope_append and decode_attend 30 times each (bf16 on the mma route, fp32
    on simt), returns the cache it was given, and agrees with the functional
    step (the blend) in logits and caches, normalised (max|d| / max|ref|):
    2e-4 in fp32, 2e-2 in bf16, where the 30 blocks pass on each other's
    roundings (element by element a bf16 cache differs by an ulp)."""
    dtype = DTYPES[name]
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(), n_layers=30)
    params = api.init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                             device="cuda", dtype=dtype)
    cache = api.init_cache(cfg, 4, 64, dtype, device="cuda")
    toks = torch.randint(0, cfg.vocab, (4, 1), device="cuda")
    pos = torch.tensor([0, 5, 63, 70], device="cuda")
    with torch.inference_mode():
        want, ref = api.decode_step(params, cfg, cache, toks, pos, compute_dtype=dtype)
        before = (rope_append.launches, dict(decode_attend.launches_by_route))
        got, out = api.decode_step(params, cfg, cache, toks, pos, compute_dtype=dtype,
                                   donate=True)
    torch.cuda.synchronize()
    route = "mma" if name == "bfloat16" else "simt"
    assert rope_append.launches - before[0] == 30
    assert decode_attend.launches_by_route[route] - before[1][route] == 30
    assert out is cache
    tol = 2e-4 if name == "float32" else 2e-2
    for out_t, ref_t in ((got, want), (cache["k"], ref["k"]), (cache["v"], ref["v"])):
        err = (out_t.float() - ref_t.float()).abs().max() / ref_t.float().abs().max()
        assert err <= tol, err
    assert bool(got.isfinite().all())
