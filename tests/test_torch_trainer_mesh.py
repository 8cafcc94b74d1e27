"""The port's Trainer on a mesh (``Trainer(mesh=)``) over four gloo ranks on
the CPU: a run on a (data 4, model 1) mesh checkpoints, and the checkpoint
restores onto a (data 2, model 2) mesh, as ``tests/test_elastic_reshard.py``
restores the reference's from a 4x2 mesh onto a 2x2 one.

StarCoder2-3B reduced, fp32 compute. The 4x1 run takes 4 steps and
checkpoints after step 3 and step 4; its losses and grad norms follow the
one-card Trainer's at 2e-4. ``restore_trainer_state`` of step 3 on the 2x2
mesh gives every param and moment bit-equal to the checkpoint's global
arrays, on the placements of the new mesh, and one more step there gives
the 4x1 run's fourth loss at 2e-4. The checkpoint is written once, by
rank 0, in the reference's layout (``repro.checkpoint.store`` reads it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import store as jax_store  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_ranks  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer, restore_trainer_state  # noqa: E402
from repro_torch.tree import flatten, leaves, map_tree  # noqa: E402

ARCH, TOL, STEPS = "starcoder2-3b", 2e-4, 4
SHAPE = ShapeSpec("t", "train", 16, 4)


def _tcfg(ckpt_dir, steps=STEPS, compression=False):
    return TrainConfig(steps=steps, ckpt_every=3, ckpt_dir=ckpt_dir, log_every=100,
                       compute_dtype="float32", grad_compression=compression)


def _ranks(rank, world, ckpt_dir, ckpt_dir_c):
    from torch.distributed.tensor import DTensor

    torch.set_num_threads(1)
    cfg = get_config(ARCH).reduced()
    out = {}
    mesh_a = make_mesh((4, 1), ("data", "model"), device_type="cpu")
    ta = Trainer(cfg, SHAPE, _tcfg(ckpt_dir), mesh=mesh_a)
    ta.run()
    out["stats_a"] = [(s["loss"], s["grad_norm"]) for s in ta.stats]

    mesh_b = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    tb = Trainer(cfg, SHAPE, _tcfg(ckpt_dir), mesh=mesh_b)
    params, opt = restore_trainer_state(tb, 3)
    tree = {"params": params, "opt": opt}
    out["restored"] = {k: (v.full_tensor() if isinstance(v, DTensor) else v).numpy().copy()
                       for k, v in flatten(tree)}  # copies: the step below updates in place
    placed = map_tree(lambda leaf, spec: leaf.device_mesh is mesh_b and
                      tuple(leaf.placements) == sharding.placements(spec, mesh_b),
                      params, sharding.param_pspecs(params, mesh_b),
                      is_leaf=lambda x: isinstance(x, torch.Tensor))
    out["placed"] = all(leaves(placed))
    out["local_wq"] = tuple(params["blocks"]["attn"]["wq"].to_local().shape)
    params, opt, loss, gnorm = tb.train_step(params, opt, tb._make_batch(3))
    out["step_b"] = (loss.item(), gnorm.item())

    tc = Trainer(cfg, SHAPE, _tcfg(ckpt_dir_c, steps=2, compression=True), mesh=mesh_b)
    tc.run()
    out["stats_c"] = [(s["loss"], s["grad_norm"]) for s in tc.stats]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d, dc = tmp_path_factory.mktemp("mesh"), tmp_path_factory.mktemp("compressed")
    ranks = spawn_ranks(_ranks, 4, backend="gloo", timeout=120, join_timeout=300,
                        args=(str(d), str(dc)))
    cfg = get_config(ARCH).reduced()
    one = Trainer(cfg, SHAPE, _tcfg(str(tmp_path_factory.mktemp("one"))), device="cpu")
    one.run()
    one_c = Trainer(cfg, SHAPE, _tcfg(str(tmp_path_factory.mktemp("one_c")), steps=2,
                                      compression=True), device="cpu")
    one_c.run()
    return ranks, str(d), [(s["loss"], s["grad_norm"]) for s in one.stats], \
        [(s["loss"], s["grad_norm"]) for s in one_c.stats]


def _close(got, want):
    for (loss, gnorm), (wloss, wgnorm) in zip(got, want, strict=True):
        assert abs(loss - wloss) <= TOL * abs(wloss)
        assert abs(gnorm - wgnorm) <= TOL * abs(wgnorm)


def test_mesh_trainer_follows_the_one_card_trainer(runs):
    ranks, _, one, _ = runs
    for r in ranks:
        _close(r["stats_a"], one)


def test_checkpoint_restores_bit_equal_onto_another_mesh(runs):
    ranks, d, _, _ = runs
    with np.load(f"{d}/step_{3:08d}/arrays.npz") as z:
        saved = {k: z[k] for k in z.files}
    for r in ranks:
        assert sorted(r["restored"]) == sorted(saved)
        for k, v in saved.items():
            assert np.array_equal(r["restored"][k], v), k
        assert r["placed"]
        assert r["local_wq"] == (2, 128 // 2, 128 // 2)  # (L, d/data, H*hd/model)
    assert store.meta(d, 3)["n_devices"] == 4


def test_step_after_the_restore_matches_the_first_mesh(runs):
    ranks, _, _, _ = runs
    for r in ranks:
        _close([r["step_b"]], [r["stats_a"][3]])


def test_checkpoint_reads_in_the_jax_store(runs):
    _, d, _, _ = runs
    import jax.numpy as jnp

    with np.load(f"{d}/step_{4:08d}/arrays.npz") as z:
        like = {k: jnp.zeros(z[k].shape, z[k].dtype) for k in z.files}
    out = jax_store.restore(d, 4, like)
    with np.load(f"{d}/step_{4:08d}/arrays.npz") as z:
        assert all(np.array_equal(np.asarray(out[k]), z[k]) for k in z.files)


def test_compressed_grads_on_a_mesh_follow_one_card(runs):
    ranks, _, _, one_c = runs
    for r in ranks:
        _close(r["stats_c"], one_c)
