"""The audio family (Whisper's encoder-decoder; decode against random self and cross K/V): ``build_step(mesh=)`` on
a (data 2, model 2) gloo mesh of four CPU ranks against the JAX package's
unsharded functions, as ``tests/torch_sharded_family.py`` describes."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch_sharded_family as fam  # noqa: E402

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def runs():
    return fam.run(ARCH)


def test_sharded_prefill_matches_unsharded_jax(runs):
    ranks, ref = runs
    for r in ranks:
        assert fam.err(r["prefill"], ref["prefill"]) <= fam.TOL


def test_sharded_decode_matches_unsharded_jax(runs):
    ranks, ref = runs
    for r in ranks:
        for got, want in zip(r["decode"], ref["decode"], strict=True):
            assert fam.err(got, want) <= fam.TOL


def test_sharded_train_steps_match_unsharded_jax(runs):
    ranks, ref = runs
    for r in ranks:
        for (loss, gnorm), (jloss, jgnorm) in zip(r["train"], ref["train"], strict=True):
            assert abs(loss - jloss) <= fam.TOL * abs(jloss)
            assert abs(gnorm - jgnorm) <= fam.TOL * abs(jgnorm)


def test_sharded_train_updates_every_leaf_as_jax(runs):
    ranks, ref = runs
    for r in ranks:
        for k, e in fam.update_errs(r, ref).items():
            assert e <= fam.TOL, (k, e)
