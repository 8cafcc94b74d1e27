"""The port's continuous batcher (repro_torch.serve.scheduler) against the
JAX package's, on the request mixes of tests/test_serving.py, with the JAX
initialiser's weights carried across. Both decode in bf16 with a bf16
cache; completions must agree token for token, and ``steps`` and
``utilization`` exactly. Greedy decoding in bf16 could flip a token where
two logits are closer than one bf16 step; the test also holds every
tick's logits to JAX's at 2e-2 and counts such near-ties."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serve import scheduler as jax_scheduler  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import scheduler  # noqa: E402


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
