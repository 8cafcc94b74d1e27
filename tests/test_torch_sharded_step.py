"""The port's sharded steps (``train.steps.build_step(mesh=)``) on a (data 2,
model 2) mesh of four gloo ranks on the CPU, against the JAX package's
unsharded functions on the same NumPy weights and batches, and what they
stand on: ``parallel.act.constrain``, the kernel wrappers under DTensor,
and ``launch.specs``.

The oracle is unsharded: the reference's own sharded step does not run on
jax 0.9.0 (its embedding gather ``params["embed"][tokens]`` on a sharded
table raises ``ShardingTypeError``), and GSPMD promises the unsharded
values. StarCoder2-3B reduced (2 layers, d 128, 4 heads on 2 KV heads,
vocab 512) in fp32: prefill logits (the kernel route: on the CPU each
kernel's plain version, called on the local shards), three decode ticks
against a sequence-sharded cache, and two AdamW train steps (loss, grad
norm, the updated params), all at 2e-4 relative to the reference's
largest element.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, spawn_ranks  # noqa: E402
from repro_torch.parallel import act  # noqa: E402

ARCH, TOL, TRAIN_STEPS, TICKS = "starcoder2-3b", 2e-4, 2, 3
PREFILL = ShapeSpec("p", "prefill", 16, 4)
DECODE = ShapeSpec("d", "decode", 8, 4)
TRAIN = ShapeSpec("t", "train", 16, 4)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _ranks(rank, world, params_np, batches):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    torch.set_num_threads(1)
    cfg = get_config(ARCH).reduced()
    mesh = make_local_mesh(model=2, device_type="cpu")
    out = {}

    # constrain: a no-op without a table or a mesh; a redistribution with both
    x = distribute_tensor(torch.arange(48.0).reshape(4, 3, 4), mesh, (Replicate(), Shard(1)))
    table = dict(act.default_specs(mesh), _mesh=mesh)
    with act.activation_specs(act.default_specs(mesh)):
        out["no_mesh"] = act.constrain(x, "act") is x
    with act.activation_specs(table):
        y = act.constrain(x, "act")
        out["act"] = (tuple(y.placements), torch.equal(y.full_tensor(), x.full_tensor()))
        out["too_long"] = act.constrain(x, "heads") is x
        try:
            act.constrain(torch.zeros(4, 3, 4), "act")
            out["plain_refused"] = False
        except TypeError:
            out["plain_refused"] = True

    # every kernel wrapper refuses a DTensor before any launch
    d2 = distribute_tensor(torch.ones(4, 8), mesh, (Shard(0), Replicate()))
    d4 = distribute_tensor(torch.ones(2, 4, 2, 8), mesh, (Shard(0), Replicate()))
    calls = {"matmul": lambda: matmul(d2, d2.t().contiguous()),
             "rmsnorm": lambda: rmsnorm(d2, torch.ones(8)),
             "flash_attention": lambda: flash_attention(d4, d4, d4),
             "conv2d": lambda: conv2d(d4, d4),
             "ssd": lambda: ssd(d4, d2, torch.ones(2), d2, d2)}
    out["refused"] = {}
    for name, call in calls.items():
        try:
            call()
            out["refused"][name] = False
        except TypeError as e:
            out["refused"][name] = "DTensor" in str(e)
    # ... and the sharded entry runs each kernel's local call on the shards
    w = distribute_tensor(torch.ones(8, 6), mesh, (Replicate(), Shard(1)))
    with act.activation_specs(table):
        from repro_torch.kernels.matmul.ops import matmul_on_shards
        mm = matmul_on_shards(d2, w)
    out["on_shards"] = (tuple(mm.placements), tuple(mm.to_local().shape),
                        torch.equal(mm.full_tensor(), torch.full((4, 6), 8.0)))

    params = transformer.params_from_jax(params_np, device="cpu")
    tb = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731

    prefill = steps.build_step(cfg, PREFILL, mesh=mesh, device="cpu",
                               compute_dtype=torch.float32)
    logits = prefill(params, tb(batches["prefill"]))
    out["prefill"] = (logits.full_tensor().numpy(), tuple(logits.placements),
                      tuple(logits.to_local().shape))

    decode = steps.build_step(cfg, DECODE, mesh=mesh, device="cpu", compute_dtype=torch.float32)
    dec = tb(batches["decode"])
    cache = transformer.params_from_jax(batches["decode_cache"], device="cpu")
    ticks = []
    for i in range(TICKS):
        lg, cache = decode(params, cache, dec["tokens"] + i, dec["pos"] + i)
        ticks.append(lg.full_tensor().numpy())
    out["decode"] = ticks
    out["cache_placements"] = tuple(cache["k"].placements)

    train = steps.build_step(cfg, TRAIN, mesh=mesh, device="cpu", compute_dtype=torch.float32,
                             opts=steps.StepOptions(remat="full", constrain_grads=rank % 2 == 0))
    opt = adamw.init(params)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, opt, loss, gnorm = train(params, opt, tb(batches["train"]))
        losses.append((loss.item(), gnorm.item()))
    out["train"] = losses
    out["params"] = {k: v.full_tensor().numpy() for k, v in
                     [("embed", params["embed"]), ("lm_head", params["lm_head"]),
                      ("wq", params["blocks"]["attn"]["wq"]),
                      ("w_down", params["blocks"]["mlp"]["w_down"]),
                      ("ln1", params["blocks"]["ln1"]["scale"])]}
    out["param_placements"] = tuple(params["blocks"]["attn"]["wq"].placements)
    out["grad_free"] = all(not t.requires_grad for t in [params["embed"], opt.mu["embed"]])

    # the collectives of a prefill, a decode tick and a train step, by kind
    # (rank 0's, whose train step pins its gradients), for the dry run's counter
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.hlo_stats import kind_counts

    out["comm_counts"] = {}
    calls = {"prefill": lambda p: prefill(p, tb(batches["prefill"])),
             "decode": lambda p: decode(p, transformer.params_from_jax(batches["decode_cache"],
                                                                       device="cpu"),
                                        dec["tokens"], dec["pos"]),
             "train": lambda p: train(p, adamw.init(p), tb(batches["train"]))}
    for kind, call in calls.items():
        with CommDebugMode() as comm:
            call(transformer.params_from_jax(params_np, device="cpu"))
        out["comm_counts"][kind] = kind_counts(comm.get_comm_counts())

    # the blocking functional collectives (what a CUDA mesh over gloo runs)
    # give the same prefill and train step
    from repro_torch.parallel.collectives import blocking_functional_collectives

    blocking_functional_collectives("cpu")
    params = transformer.params_from_jax(params_np, device="cpu")
    out["blocking_prefill"] = prefill(params, tb(batches["prefill"])).full_tensor().numpy()
    _, _, loss, gnorm = train(params, adamw.init(params), tb(batches["train"]))
    out["blocking_train"] = (loss.item(), gnorm.item())
    x = distribute_tensor(torch.arange(96.0).reshape(8, 12), mesh, (Shard(0), Shard(1)))
    out["blocking_redistribute"] = [
        torch.equal(x.redistribute(mesh, want).full_tensor(), x.full_tensor())
        for want in [(Replicate(), Replicate()), (Shard(1), Shard(0)), (Replicate(), Shard(1))]]
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg = jax_get_config(ARCH).reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    params_np = _np(jparams)
    jb = {k: jax_specs.make_batch(jcfg, s, seed=i) for i, (k, s) in
          enumerate([("prefill", PREFILL), ("decode", DECODE), ("train", TRAIN)])}
    cache = jb["decode"].pop("cache")
    batches = {k: {n: np.asarray(v) for n, v in b.items()} for k, b in jb.items()}
    batches["decode"]["pos"] = np.zeros(DECODE.global_batch, np.int32)
    batches["decode_cache"] = jax.tree.map(np.asarray, cache)  # bf16, as JAX's
    ranks = spawn_ranks(_ranks, 4, backend="gloo", timeout=120, join_timeout=300,
                        args=(params_np, batches))

    ref = {"prefill": np.asarray(jax_api.prefill_logits(jparams, jcfg, jb["prefill"],
                                                        compute_dtype=jnp.float32))}
    ticks, c = [], cache
    for i in range(TICKS):
        lg, c = jax_api.decode_step(jparams, jcfg, c, jb["decode"]["tokens"] + i,
                                    jnp.asarray(batches["decode"]["pos"]) + i,
                                    compute_dtype=jnp.float32)
        ticks.append(np.asarray(lg))
    ref["decode"] = ticks
    ocfg = jax_adamw.AdamWConfig()

    @jax.jit
    def jstep(p, o, batch):
        loss, g = jax.value_and_grad(jax_api.loss_fn)(p, jcfg, batch, remat="none",
                                                      compute_dtype=jnp.float32)
        p, o, st = jax_adamw.apply(g, o, p, ocfg)
        return p, o, loss, st["grad_norm"]

    p, o, losses = jparams, jax_adamw.init(jparams), []
    for _ in range(TRAIN_STEPS):
        p, o, loss, gnorm = jstep(p, o, jb["train"])
        losses.append((float(loss), float(gnorm)))
    ref["train"] = losses
    ref["params"] = {"embed": p["embed"], "lm_head": p["lm_head"], "wq": p["blocks"]["attn"]["wq"],
                     "w_down": p["blocks"]["mlp"]["w_down"], "ln1": p["blocks"]["ln1"]["scale"]}
    return ranks, ref


def _err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def test_constrain_without_and_with_a_table(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["no_mesh"] and r["too_long"] and r["plain_refused"]
        assert r["act"] == ((Shard(0), Replicate()), True)


def test_constrain_is_the_identity_with_no_table():
    x = torch.ones(2, 3, 4)
    assert act.constrain(x, "act") is x
    with act.activation_specs({"act": ("data", None, None)}):  # a table with no mesh
        assert act.constrain(x, "act") is x
    assert act.gathered(x) is x


@pytest.mark.parametrize("name", ["matmul", "rmsnorm", "flash_attention", "conv2d", "ssd"])
def test_every_wrapper_refuses_a_dtensor(runs, name):
    ranks, _ = runs
    assert all(r["refused"][name] for r in ranks)


def test_matmul_on_shards_runs_on_local_shards(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["on_shards"] == ((Shard(0), Shard(1)), (2, 3), True)


def test_sharded_prefill_matches_unsharded_jax(runs):
    ranks, ref = runs
    for r in ranks:
        logits, placements, local = r["prefill"]
        assert _err(logits, ref["prefill"]) <= TOL
        assert placements == (Shard(0), Shard(2))  # (data, None, model)
        assert local == (PREFILL.global_batch // 2, PREFILL.seq_len, 512 // 2)


def test_sharded_decode_matches_unsharded_jax(runs):
    ranks, ref = runs
    for r in ranks:
        for got, want in zip(r["decode"], ref["decode"]):
            assert _err(got, want) <= TOL
        assert r["cache_placements"] == (Shard(1), Shard(2))  # (None, dp, model, ...)


def test_sharded_train_steps_match_unsharded_jax(runs):
    ranks, ref = runs
    for r in ranks:
        for (loss, gnorm), (jloss, jgnorm) in zip(r["train"], ref["train"]):
            assert abs(loss - jloss) <= TOL * abs(jloss)
            assert abs(gnorm - jgnorm) <= TOL * abs(jgnorm)
        for k, v in r["params"].items():
            assert _err(v, ref["params"][k]) <= TOL, k
        assert r["param_placements"] == (Shard(1), Shard(2))  # (None, fsdp, model)
        assert r["grad_free"]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "llava-next-34b", "whisper-base"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_make_batch_equals_the_reference(arch, shape):
    """Every input of the shape's kind, drawn from one seed by both packages
    (the VLM's patches and the audio family's frames in bf16); the meta
    specs' shapes are the reference's."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    kind = SHAPES[shape].kind
    shp = ShapeSpec(shape, kind, 8 if kind == "decode" else cfg.n_patches + 8, 2)
    want = jax_specs.make_batch(jcfg, shp, seed=3)
    got = specs.make_batch(cfg, shp, seed=3, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "cache":
            continue
        w = np.asarray(want[k]).astype(np.float32) if want[k].dtype == jnp.bfloat16 \
            else np.asarray(want[k])
        g = got[k].float().numpy() if got[k].dtype == torch.bfloat16 else got[k].numpy()
        assert g.shape == w.shape and str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert np.array_equal(g, w), k
    meta = specs.input_specs(cfg, shp)
    for k, v in jax_specs.input_specs(jcfg, shp).items():
        if k == "cache":
            assert jax.tree.map(lambda s: s.shape, v) == \
                jax.tree.map(lambda t: tuple(t.shape), meta[k])
            continue
        assert tuple(meta[k].shape) == v.shape and meta[k].device.type == "meta"


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dry_run_counts_the_collectives_of_the_real_run(runs, kind):
    """The dry run's counter, on fake tensors over a fake (2, 2) process group,
    counts by kind the collectives that ``CommDebugMode`` saw rank 0 make in
    the real gloo run of the same step."""
    from repro_torch.launch.dryrun import count_step, fake_world
    from repro_torch.train.steps import StepOptions

    ranks, _ = runs
    shape = {"prefill": PREFILL, "decode": DECODE, "train": TRAIN}[kind]
    with fake_world((2, 2), device_type="cpu") as mesh:
        counter = count_step(get_config(ARCH).reduced(), shape, mesh,
                             StepOptions(remat="full", constrain_grads=True))
    got = counter.collective_stats().count_by_kind
    assert got == ranks[0]["comm_counts"][kind] and sum(got.values()) > 0


def test_blocking_functional_collectives_give_the_same_steps(runs):
    """The kernels ``make_mesh`` installs for a CUDA mesh over gloo, installed
    for the CPU ranks: the same prefill logits and first train step."""
    ranks, ref = runs
    for r in ranks:
        assert all(r["blocking_redistribute"])
        assert _err(r["blocking_prefill"], r["prefill"][0]) <= 1e-6
        loss, gnorm = r["blocking_train"]
        assert abs(loss - r["train"][0][0]) <= 1e-6 * abs(loss)
        assert abs(gnorm - r["train"][0][1]) <= 1e-6 * abs(gnorm)
