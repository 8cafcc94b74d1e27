"""The port's continuous batcher (repro_torch.serve.scheduler) against the
JAX package's, on the request mixes of tests/test_serving.py, with the JAX
initialiser's weights carried across. Both decode in bf16 with a bf16
cache; completions must agree token for token, and ``steps`` and
``utilization`` exactly. Greedy decoding in bf16 could flip a token where
two logits are closer than one bf16 step; the test also holds every
tick's logits to JAX's at 2e-2 and counts such near-ties.

The hybrid (Zamba2) and xLSTM families are held to JAX's batcher serving
each request alone, since the reference's batcher leaks recurrent state
into reused slots; the MoE family to JAX's batcher. Then int8 weight-only
quantization (``serve/quant.py``) and the hybrid LM plan
(``train/hybrid.py``), as tests/test_serving.py holds the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serve import scheduler as jax_scheduler  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.serve import scheduler  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from repro_torch.tree import leaves as flatten_leaves  # noqa: E402


@pytest.fixture(scope="module")
def tiny_lm():  # tests/test_serving.py::tiny_lm, in both packages
    jcfg = jax_get_config("starcoder2-3b").reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("starcoder2-3b").reduced(), tparams


def _completions_mix(cfg):  # tests/test_serving.py::test_batcher_completes_all_requests
    rng = np.random.default_rng(0)
    reqs = [dict(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab, 5 + i)], max_new=4)
            for i in range(5)]
    return dict(slots=2, max_seq=64), reqs


def _crowded_mix(cfg):  # tests/test_serving.py::test_batcher_matches_single_request_decode
    rng = np.random.default_rng(1)
    reqs = [dict(rid=9, prompt=[int(t) for t in rng.integers(0, cfg.vocab, 9)], max_new=3),
            dict(rid=0, prompt=[5, 7, 11, 13], max_new=6),
            dict(rid=8, prompt=[int(t) for t in rng.integers(0, cfg.vocab, 3)], max_new=3)]
    return dict(slots=2, max_seq=32), reqs


def _solo_mix(cfg):
    return dict(slots=1, max_seq=32), [dict(rid=0, prompt=[5, 7, 11, 13], max_new=6)]


def _eos_mix(cfg):  # tests/test_serving.py::test_batcher_eos_stops_early, with its probe's EOS
    return dict(slots=1, max_seq=64), [dict(rid=0, prompt=[1, 2, 3], max_new=10, eos="first")]


def _bf16_step(x: float) -> float:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def _watch(b, record):
    """Record the logits of every tick of batcher ``b`` (either package)."""
    decode = b._decode

    def watched(*args):
        logits, cache = decode(*args)
        record.append(np.asarray(logits, np.float32).copy())
        return logits, cache

    b._decode = watched


def _run(pkg, cfg, params, kw, reqs, record, **extra):
    b = pkg.ContinuousBatcher(cfg, params, **kw, **extra)
    _watch(b, record)
    for r in reqs:
        b.submit(pkg.Request(**r))
    return b.run(), b


@pytest.mark.parametrize("mix", [_completions_mix, _crowded_mix, _solo_mix, _eos_mix])
def test_batcher_matches_jax(mix, tiny_lm):
    jcfg, jparams, cfg, tparams = tiny_lm
    kw, reqs = mix(cfg)
    if reqs[0].get("eos") == "first":  # the probe: the first greedy token is the EOS
        probe, _ = _run(jax_scheduler, jcfg, jparams, kw,
                        [dict(rid=0, prompt=[1, 2, 3], max_new=1)], [])
        reqs[0]["eos"] = probe[0].tokens[0]
    ours_logits, ref_logits = [], []
    ours, tb = _run(scheduler, cfg, tparams, kw, reqs, ours_logits, device="cpu")
    ref, jb = _run(jax_scheduler, jcfg, jparams, kw, reqs, ref_logits)
    assert [(c.rid, c.tokens, c.prompt_len, c.steps_in_flight) for c in ours] == \
        [(c.rid, [int(t) for t in c.tokens], c.prompt_len, c.steps_in_flight) for c in ref]
    assert tb.steps == jb.steps == len(ours_logits) == len(ref_logits)
    assert tb.utilization == jb.utilization
    assert sorted(c.rid for c in ours) == sorted(r["rid"] for r in reqs)
    # Every tick's logits agree at the bf16 tolerance; the top-1 margins say
    # how much the token-for-token agreement above rests on: a margin below
    # one bf16 step of the top logit is a near-tie that rounding alone could
    # flip, and there the tolerance on the logits is the comparison.
    margins = []
    for got, want in zip(ours_logits, ref_logits):
        assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2
        top2 = np.sort(got, axis=-1)[:, -2:]
        margins += [(t1 - t0, _bf16_step(t1)) for t0, t1 in top2]
    smallest = min(m for m, _ in margins)
    near_ties = sum(m < step for m, step in margins)
    assert smallest >= 0 and near_ties < len(margins) / 4, (smallest, near_ties, len(margins))


_PHASES = ["serve.admit", "serve.gather", "serve.decode", "serve.sync", "serve.commit"]


def _check_tick_spans(b):
    """One ``serve.tick`` a tick with the five phases inside it, in order;
    its ``busy`` sums to ``busy_slot_steps`` and its ``generated`` to the
    tokens of the completions and of the requests in flight."""
    evs = b.spans.events()
    ticks = [e for e in evs if e["name"] == "serve.tick" and "tick" in e["attrs"]]
    assert [t["attrs"]["tick"] for t in ticks] == list(range(1, b.steps + 1))
    for t in ticks:
        kids = [e for e in evs if e["parent"] == t["id"]]
        assert [k["name"] for k in kids] == _PHASES
        assert all(t["ts"] <= k["ts"] and k["ts"] + k["dur"] <= t["ts"] + t["dur"] + 1e-6
                   for k in kids)
    assert sum(t["attrs"]["busy"] for t in ticks) == b.busy_slot_steps
    in_flight = sum(len(st["out"]) for st in b.active if st is not None)
    assert sum(t["attrs"]["generated"] for t in ticks) == \
        sum(len(c.tokens) for c in b.done) + in_flight
    return evs


def test_batcher_records_its_ticks(tiny_lm):
    _, _, cfg, tparams = tiny_lm
    kw, reqs = _completions_mix(cfg)
    b = scheduler.ContinuousBatcher(cfg, tparams, **kw, device="cpu")
    for r in reqs:
        b.submit(scheduler.Request(**r))
    for _ in range(16):  # two done, one generating, one in its prompt
        b.step()
    assert b.done and any(st is not None and st["out"] for st in b.active)
    _check_tick_spans(b)
    b.run()
    evs = _check_tick_spans(b)
    assert sorted(r for e in evs if e["name"] == "serve.admit" for r in e["attrs"]["rids"]) == \
        sorted(r["rid"] for r in reqs)
    idle = [e for e in evs if e["name"] == "serve.tick" and "tick" not in e["attrs"]]
    assert len(idle) == 1 and [e["name"] for e in evs if e["parent"] == idle[0]["id"]] == \
        ["serve.admit"]


def test_batcher_default_device_raises_without_cuda(tiny_lm):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, _, cfg, tparams = tiny_lm
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler.ContinuousBatcher(cfg, tparams)


# ---------------------------------------------------------------------------
# The hybrid family (Zamba2): recurrent conv and SSM state per slot
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_hybrid():
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("zamba2-2.7b").reduced(), tparams


def _hybrid_mix(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab, 5 + i)], max_new=6)
            for i in range(n)]


def _tokens_by_rid(done):
    return {c.rid: [int(t) for t in c.tokens] for c in done}


def test_hybrid_batcher_matches_jax(tiny_hybrid):
    """Every request is admitted at tick 0 (as many slots as requests), so no
    slot is reused and the reference's stale-state fault cannot show. The
    top-1 margins say how much the token agreement rests on: a margin below
    one bf16 step can flip (with 4 requests of seed 4 a margin of 0.0015 at
    2.46 does, and the histories part from there). The logits themselves
    drift apart in bf16 as the recurrent states do (up to 2.7e-2 here,
    tests/test_torch_zamba.py says why), so they are not held at 2e-2."""
    jcfg, jparams, cfg, tparams = tiny_hybrid
    reqs = _hybrid_mix(cfg, 3)
    kw = dict(slots=3, max_seq=32)
    ours_logits, ref_logits = [], []
    ours, tb = _run(scheduler, cfg, tparams, kw, reqs, ours_logits, device="cpu")
    ref, jb = _run(jax_scheduler, jcfg, jparams, kw, reqs, ref_logits)
    assert [(c.rid, c.tokens, c.prompt_len, c.steps_in_flight) for c in ours] == \
        [(c.rid, [int(t) for t in c.tokens], c.prompt_len, c.steps_in_flight) for c in ref]
    assert (tb.steps, tb.utilization) == (jb.steps, jb.utilization)
    assert tb.steps == len(ours_logits) == len(ref_logits)
    margins = []
    for got in ours_logits:
        top2 = np.sort(got, axis=-1)[:, -2:]
        margins += [(t1 - t0, _bf16_step(t1)) for t0, t1 in top2]
    near_ties = sum(m < step for m, step in margins)
    assert near_ties < len(margins) / 4, (near_ties, len(margins))


def _jax_solo(jcfg, jparams, reqs, max_seq):
    return {r["rid"]: _tokens_by_rid(_run(jax_scheduler, jcfg, jparams,
                                          dict(slots=1, max_seq=max_seq), [r], [])[0])[r["rid"]]
            for r in reqs}


@pytest.mark.parametrize("slots,n", [(1, 3), (2, 5)])
def test_hybrid_batcher_reused_slot_matches_solo(slots, n, tiny_hybrid):
    """Slots are reused: each completion equals JAX's for that request served
    alone, because admission zeroes the slot's conv and SSM lines."""
    jcfg, jparams, cfg, tparams = tiny_hybrid
    reqs = _hybrid_mix(cfg, n)
    ours, tb = _run(scheduler, cfg, tparams, dict(slots=slots, max_seq=32), reqs, [],
                    device="cpu")
    assert tb.steps > max(len(r["prompt"]) + r["max_new"] - 1 for r in reqs)  # slots reused
    assert _tokens_by_rid(ours) == _jax_solo(jcfg, jparams, reqs, 32)


def test_jax_batcher_leaks_recurrent_state(tiny_hybrid):
    """The reference's fault (ROADMAP.md queue 3, fault 4): its batcher reuses
    a slot without clearing the recurrent state, so every request after the
    first on one slot starts from its predecessor's state."""
    jcfg, jparams, cfg, _ = tiny_hybrid
    reqs = _hybrid_mix(cfg, 3)
    ref, _ = _run(jax_scheduler, jcfg, jparams, dict(slots=1, max_seq=32), reqs, [])
    got, solo = _tokens_by_rid(ref), _jax_solo(jcfg, jparams, reqs, 32)
    assert got[0] == solo[0]
    assert got[1] != solo[1] and got[2] != solo[2]


def test_hybrid_admit_zeroes_recurrent_state(tiny_hybrid):
    _, _, cfg, tparams = tiny_hybrid
    b = scheduler.ContinuousBatcher(cfg, tparams, slots=2, max_seq=32, device="cpu")
    b.submit(scheduler.Request(rid=0, prompt=[1, 2, 3], max_new=2))
    for _ in range(3):
        b.step()
    assert b.cache["ssm"][:, :, 0].abs().sum() > 0 and b.cache["conv"][:, :, 0].abs().sum() > 0
    assert (b.cache["ssm"][:, :, 1] != 0).any()  # the idle slot ran token 0 too
    k_before = b.cache["k"].clone()
    b.submit(scheduler.Request(rid=1, prompt=[4, 5], max_new=2))
    b._admit()
    assert b.active[1]["req"].rid == 1
    assert (b.cache["conv"][:, :, 1] == 0).all() and (b.cache["ssm"][:, :, 1] == 0).all()
    assert (b.cache["ssm"][:, :, 0] != 0).any()  # the busy slot keeps its state
    assert torch.equal(b.cache["k"], k_before)  # the KV cache is masked, not wiped


# ---------------------------------------------------------------------------
# The recurrent family (xLSTM): per-block mLSTM and sLSTM state per slot
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_xlstm():
    jcfg = jax_get_config("xlstm-350m").reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("xlstm-350m").reduced(), tparams


@pytest.mark.parametrize("slots,n", [(1, 3), (2, 5)])
def test_xlstm_batcher_reused_slot_matches_solo(slots, n, tiny_xlstm):
    """Slots are reused: each completion equals JAX's for that request served
    alone, because admission puts the slot's mLSTM and sLSTM states back to
    their initial values (m at -1e30)."""
    jcfg, jparams, cfg, tparams = tiny_xlstm
    reqs = _hybrid_mix(cfg, n, seed=2)
    ours, tb = _run(scheduler, cfg, tparams, dict(slots=slots, max_seq=32), reqs, [],
                    device="cpu")
    assert tb.steps > max(len(r["prompt"]) + r["max_new"] - 1 for r in reqs)  # slots reused
    assert _tokens_by_rid(ours) == _jax_solo(jcfg, jparams, reqs, 32)


def test_jax_batcher_leaks_xlstm_state(tiny_xlstm):
    """The reference's fault 4 on xLSTM (ROADMAP.md queue 3): its batcher
    reuses a slot without resetting the mLSTM and sLSTM states, so every
    request after the first on one slot starts from its predecessor's."""
    jcfg, jparams, _, _ = tiny_xlstm
    reqs = _hybrid_mix(jcfg, 3, seed=2)
    ref, _ = _run(jax_scheduler, jcfg, jparams, dict(slots=1, max_seq=32), reqs, [])
    got, solo = _tokens_by_rid(ref), _jax_solo(jcfg, jparams, reqs, 32)
    assert got[0] == solo[0]
    assert got[1] != solo[1]  # (request 2's tokens happen to survive its leaked start)
    b = jax_scheduler.ContinuousBatcher(jcfg, jparams, slots=1, max_seq=32)
    b.submit(jax_scheduler.Request(**reqs[0]))
    while not b.done:
        b.step()
    b.submit(jax_scheduler.Request(**reqs[1]))
    b._admit()
    assert b.active[0]["req"].rid == 1
    assert (np.asarray(b.cache[0]["m"][0]) != -1e30).all()  # not the initial state
    assert np.abs(np.asarray(b.cache[1]["c"][0])).max() > 0


def test_xlstm_admit_resets_state_by_kind(tiny_xlstm):
    """mLSTM: C and n to 0, m to -1e30 (its initial value; a zero m is another
    state); sLSTM: h and c to 0. The busy slot keeps its state."""
    _, _, cfg, tparams = tiny_xlstm
    b = scheduler.ContinuousBatcher(cfg, tparams, slots=2, max_seq=32, device="cpu")
    b.submit(scheduler.Request(rid=0, prompt=[1, 2, 3], max_new=2))
    for _ in range(3):
        b.step()
    mlstm, slstm = b.cache
    assert set(mlstm) == {"c", "n", "m"} and set(slstm) == {"h", "c"}
    assert (mlstm["m"][1] != -1e30).all() and (slstm["c"][1] != 0).any()  # idle slot ran too
    b.submit(scheduler.Request(rid=1, prompt=[4, 5], max_new=2))
    b._admit()
    mlstm, slstm = b.cache
    assert (mlstm["c"][1] == 0).all() and (mlstm["n"][1] == 0).all()
    assert (mlstm["m"][1] == -1e30).all()
    assert (slstm["h"][1] == 0).all() and (slstm["c"][1] == 0).all()
    assert (mlstm["m"][0] != -1e30).all() and (slstm["c"][0] != 0).any()
    fresh = api.init_cache(cfg, 2, 32, device="cpu")
    for got, want in zip(b.cache, fresh):
        for key in got:
            assert torch.equal(got[key][1], want[key][1]), key


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "starcoder2-3b", "xlstm-350m"])
def test_reset_slot_of_hybrid_and_dense_caches(arch):
    """reset_slot copies a one-slot init_cache into one slot, whatever the
    slot axis of a leaf (2 in the hybrid's (G, per, slots, ...) conv and SSM
    lines, 0 in xLSTM's states); the other slots keep theirs, and the KV
    lines stay as they are (masked past pos). One slot of one is the whole
    cache but its KV lines."""
    cfg = get_config(arch).reduced()
    cache = api.init_cache(cfg, 3, 8, torch.float32, device="cpu")
    fresh = api.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    for t in flatten_leaves(cache):
        t.fill_(7.0)
    scheduler.reset_slot(cache, fresh, 2)
    for (path, got), want in zip(flatten(cache), flatten_leaves(fresh)):
        if path.rsplit("/", 1)[-1] in ("k", "v"):
            assert (got == 7.0).all(), path
            continue
        axis = next(a for a, (n, m) in enumerate(zip(got.shape, want.shape)) if n != m)
        assert got.shape[axis] == 3 and want.shape[axis] == 1, path
        assert torch.equal(got.narrow(axis, 2, 1), want), path
        assert (got.narrow(axis, 0, 2) == 7.0).all(), path
    one = api.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    for t in flatten_leaves(one):
        t.fill_(7.0)
    scheduler.reset_slot(one, fresh, 0)
    for (path, got), want in zip(flatten(one), flatten_leaves(fresh)):
        kv = path.rsplit("/", 1)[-1] in ("k", "v")
        assert (got == 7.0).all() if kv else torch.equal(got, want), path


def test_batcher_refuses_the_audio_family():
    """Requests carry no frames, so a slot's cross K/V would never be filled."""
    cfg = get_config("whisper-base").reduced()
    with pytest.raises(NotImplementedError, match="frames"):
        scheduler.ContinuousBatcher(cfg, {}, device="cpu")


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"])
def test_moe_batcher_matches_jax(arch):
    """The MoE family on the batcher, every request admitted at tick 0: the
    same schedule as the reference's (completion lengths, steps in flight,
    steps, utilization) and the same first tick's logits at 2e-2. Tokens
    are not held one for one: in bf16 a router logit one rounding away from
    a tie picks another expert, and the histories part there (with these
    weights JAX's bf16 decode leaves its own fp32 decode by 0.2 on tick 2
    while the port's stays within 0.011 of its fp32)."""
    jcfg = jax_get_config(arch).reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = get_config(arch).reduced()
    reqs = _hybrid_mix(cfg, 2, seed=3)
    kw = dict(slots=2, max_seq=32)
    ours_logits, ref_logits = [], []
    ours, tb = _run(scheduler, cfg, tparams, kw, reqs, ours_logits, device="cpu")
    ref, jb = _run(jax_scheduler, jcfg, jparams, kw, reqs, ref_logits)
    assert [(c.rid, len(c.tokens), c.prompt_len, c.steps_in_flight) for c in ours] == \
        [(c.rid, len(c.tokens), c.prompt_len, c.steps_in_flight) for c in ref]
    assert (tb.steps, tb.utilization) == (jb.steps, jb.utilization)
    got, want = ours_logits[0], ref_logits[0]
    assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2


# ---------------------------------------------------------------------------
# int8 weight-only quantization (tests/test_serving.py, on the port)
# ---------------------------------------------------------------------------


def _jax_tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "xlstm-350m", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_equal_to_jax(arch, dtype):
    """int8 values and fp32 scales bit-equal to JAX's quantize_params on the
    same tree (fp32 and bf16 weights; xLSTM's list of blocks; MoE's stacked
    (L, E, K, N) experts, one scale per output column across L and E)."""
    from repro.serve.quant import quantize_params as jax_quantize
    from repro_torch.serve.quant import quantize_params
    jcfg = jax_get_config(arch).reduced()
    jparams = jax_api.init_params(jax.random.key(1), jcfg,
                                  dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tparams = transformer.params_from_jax(_jax_tree_np(jparams), device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(jax_quantize(jparams))[0]
    ours = dict(flatten(quantize_params(tparams)))
    assert len(ref) == len(ours)
    for path, leaf in ref:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
        got = ours[key]
        want = np.asarray(leaf)
        if key.endswith("__q8__"):
            assert got.dtype == torch.int8
        elif key.endswith("/scale") and want.ndim > 1:
            assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32), key)


def test_quantize_rounds_half_to_even():
    from repro_torch.serve.quant import dequantize_params, quantize_params
    w = torch.tensor([[127.0], [2.5], [3.5], [-2.5], [0.5]])  # scale 1: x.5 to the even
    q = quantize_params({"w": w})["w"]
    assert q["scale"].item() == 1.0 and q["__q8__"][:, 0].tolist() == [127, 2, 4, -2, 0]
    assert dequantize_params({"w": q}, torch.float32)["w"][:, 0].tolist() == [127, 2, 4, -2, 0]


def test_quantized_params_are_4x_smaller(tiny_lm):
    from repro_torch.serve.quant import quantize_params, storage_bytes
    _, _, cfg, params = tiny_lm
    ratio = storage_bytes(params) / storage_bytes(quantize_params(params))
    assert ratio > 3.0, f"only {ratio:.2f}x smaller"


def test_quantized_logits_close_and_top1_stable(tiny_lm):
    from repro_torch.serve.quant import dequantize_params, quantize_params
    _, _, cfg, params = tiny_lm
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)))
    full = transformer.forward(params, cfg, toks, compute_dtype=torch.float32)
    deq = dequantize_params(quantize_params(params), dtype=torch.float32)
    qlog = transformer.forward(deq, cfg, toks, compute_dtype=torch.float32)
    agree = (full.argmax(-1) == qlog.argmax(-1)).float().mean().item()
    assert agree > 0.9, f"top-1 agreement {agree}"


def test_quantize_preserves_norm_scales(tiny_lm):
    from repro_torch.serve.quant import dequantize_params, quantize_params
    _, _, cfg, params = tiny_lm
    q = quantize_params(params)
    assert q["ln_f"]["scale"] is params["ln_f"]["scale"]
    assert dequantize_params(q)["ln_f"]["scale"].dtype == params["ln_f"]["scale"].dtype
    assert dequantize_params(q)["embed"].dtype == torch.bfloat16


def test_dequantized_within_half_a_scale(tiny_lm):
    from repro_torch.serve.quant import dequantize_params, quantize_params
    _, _, cfg, params = tiny_lm
    q = quantize_params(params)
    deq = dequantize_params(q, torch.float32)
    w, qw = params["blocks"]["attn"]["wq"], q["blocks"]["attn"]["wq"]
    assert qw["scale"].shape == (1, 1, w.shape[-1])  # one scale a column, across the layers
    assert bool(((deq["blocks"]["attn"]["wq"] - w).abs() <= qw["scale"] / 2 * (1 + 1e-6)).all())


# ---------------------------------------------------------------------------
# The hybrid LM plan (tests/test_serving.py, on the port)
# ---------------------------------------------------------------------------


def test_hybrid_lm_matches_jax_and_plain_forward(tiny_lm):
    """Sequential (the reference's mesh=None route) and pipelined against JAX's
    hybrid_lm_forward(mesh=None) and the port's transformer.forward, fp32."""
    from repro.train.hybrid import HybridLMPlan as JaxPlan
    from repro.train.hybrid import hybrid_lm_forward as jax_hybrid
    from repro_torch.train.hybrid import HybridLMPlan, hybrid_lm_forward
    jcfg, jparams, cfg, params = tiny_lm
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (4, 16))
    ref = jax_hybrid(jparams, jcfg, jnp.asarray(toks), JaxPlan(sp=2, n_stages=2, n_micro=2),
                     mesh=None, compute_dtype=jnp.float32)
    plain = transformer.forward(params, cfg, torch.from_numpy(toks),
                                compute_dtype=torch.float32)
    plan = HybridLMPlan(sp=2, n_stages=2, n_micro=2)
    for pipelined in (False, True):
        out = hybrid_lm_forward(params, cfg, torch.from_numpy(toks), plan, pipelined=pipelined,
                                compute_dtype=torch.float32)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sp,n_stages,n_micro", [(2, 2, 2), (2, 1, 4), (0, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hybrid_lm_pipelined_equals_sequential(sp, n_stages, n_micro, dtype, tiny_lm):
    """The one-device GPipe schedule computes what the stages in turn do,
    on the kernel route; bf16 too (microbatches are rows of the same products)."""
    from repro_torch.train.hybrid import HybridLMPlan, hybrid_lm_forward
    _, _, cfg, params = tiny_lm
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (4, 16)))
    plan = HybridLMPlan(sp=sp, n_stages=n_stages, n_micro=n_micro)
    seq = hybrid_lm_forward(params, cfg, toks, plan, compute_dtype=dtype)
    pipe = hybrid_lm_forward(params, cfg, toks, plan, pipelined=True, compute_dtype=dtype)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert float((pipe - seq).abs().max() / seq.abs().max()) <= tol


def test_hybrid_lm_loss_and_gradients(tiny_lm):
    """hybrid_lm_loss against JAX's on the plain route, and the pipelined
    loss's gradient against the sequential loss's, leaf by leaf (the
    reference's pipelined gradient does not run on this jax)."""
    from repro.train.hybrid import HybridLMPlan as JaxPlan
    from repro.train.hybrid import hybrid_lm_loss as jax_loss
    from repro_torch.train.hybrid import HybridLMPlan, hybrid_lm_loss
    jcfg, jparams, cfg, params = tiny_lm
    rng = np.random.default_rng(5)
    toks, labels = rng.integers(0, cfg.vocab, (4, 16)), rng.integers(0, cfg.vocab, (4, 16))
    ref = jax_loss(jparams, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                   JaxPlan(sp=2, n_stages=2, n_micro=2), None, compute_dtype=jnp.float32)
    plan = HybridLMPlan(sp=2, n_stages=2, n_micro=2)
    grads = []
    for pipelined in (False, True):
        leaf = transformer.map_tree(lambda t: t.detach().requires_grad_(), params)
        loss = hybrid_lm_loss(leaf, cfg, torch.from_numpy(toks), torch.from_numpy(labels), plan,
                              pipelined=pipelined, compute_dtype=torch.float32,
                              use_kernel=False)
        assert abs(loss.item() - float(ref)) <= 2e-4 * abs(float(ref))
        grads.append(torch.autograd.grad(loss, flatten_leaves(leaf)))
    for gs, gp in zip(*grads):
        assert bool(torch.isfinite(gp).all())
        assert float((gp - gs).abs().max()) <= 2e-4 * max(float(gs.abs().max()), 1e-12)
