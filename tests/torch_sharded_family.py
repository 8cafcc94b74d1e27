"""One family's sharded steps against the JAX package's unsharded functions.

Shared by ``tests/test_torch_sharded_<family>.py`` (one file a family, so
that ``--dist loadfile`` spreads them): ``train.steps.build_step(mesh=)`` at
``get_config(arch).reduced()`` in fp32 on a (data 2, model 2) mesh of four
gloo ranks on the CPU, the same NumPy weights, batches and caches as the
reference: the prefill logits (the kernel route: on the CPU each kernel's
plain version on the local shards), ``TICKS`` decode ticks from a cache of
random values, and ``TRAIN_STEPS`` AdamW steps (or fewer, where a family
says why): the loss and grad norm of each, and each leaf's change over the
steps, each within ``TOL`` of the reference's largest element (of the
change, for the leaves). The steps run under ``OPT``: AdamW divides by
sqrt(v) + eps, and with the default eps of 1e-8 its update is sign(g)
wherever |g| is well above 1e-8 and turns on rounding where |g| is near it,
so an elementwise comparison would measure rounding; with eps = 1 the
update is smooth in the gradient, and at lr = 1 from the first step each
leaf moves by 1e-3 to 1e-1, far above the fp32 spacing of a leaf near 1
(1.2e-7). A skipped, partial or wrong update on any shard then shows. The
oracle is unsharded: the reference's own sharded step does not run on jax
0.9.0, and GSPMD promises the unsharded values.

This module imports no JAX: the ranks are spawned processes that import it
by name.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

TOL, TICKS, TRAIN_STEPS, BATCH = 2e-4, 3, 2, 4
OPT = {"lr": 1.0, "eps": 1.0, "warmup_steps": 1}  # both packages' AdamWConfig fields


def seq_len(cfg) -> int:
    """Prefill and train positions: 16 text tokens (after the VLM's patches)."""
    return cfg.n_patches + 16


def _ranks(rank, world, arch, params_np, batches, train_steps):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.tree import flatten

    torch.set_num_threads(1)
    cfg = get_config(arch).reduced()
    mesh = make_local_mesh(model=2, device_type="cpu")
    def tb(b):  # the features the reference draws in bf16 travel as fp32
        return {k: torch.from_numpy(v).to(torch.bfloat16) if k in batches["bf16"]
                else torch.from_numpy(v) for k, v in b.items()}

    out = {}

    s = seq_len(cfg)
    params = transformer.params_from_jax(params_np, device="cpu")
    prefill = steps.build_step(cfg, ShapeSpec("p", "prefill", s, BATCH), mesh=mesh,
                               device="cpu", compute_dtype=torch.float32)
    out["prefill"] = prefill(params, tb(batches["prefill"])).full_tensor().numpy()

    decode = steps.build_step(cfg, ShapeSpec("d", "decode", batches["slots"], BATCH), mesh=mesh,
                              device="cpu", compute_dtype=torch.float32)
    dec = tb(batches["decode"])
    cache = transformer.params_from_jax(batches["cache"], device="cpu")
    ticks = []
    for i in range(TICKS):
        lg, cache = decode(params, cache, dec["tokens"] + i, dec["pos"] + i)
        ticks.append(lg.full_tensor().numpy())
    out["decode"] = ticks

    train = steps.build_step(cfg, ShapeSpec("t", "train", s, BATCH), mesh=mesh, device="cpu",
                             compute_dtype=torch.float32, ocfg=adamw.AdamWConfig(**OPT),
                             opts=steps.StepOptions(remat="full", constrain_grads=rank % 2 == 0))
    opt = adamw.init(params)
    losses = []
    for _ in range(train_steps):
        params, opt, loss, gnorm = train(params, opt, tb(batches["train"]))
        losses.append((loss.item(), gnorm.item()))
    out["train"] = losses
    out["params"] = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v).numpy()
                     for k, v in flatten(params)}
    return out


def run(arch: str, train_steps: int = TRAIN_STEPS):
    """(the ranks' results, the reference's) for ``arch``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import ShapeSpec as JaxShape
    from repro.launch import specs as jax_specs
    from repro.models import api as jax_api
    from repro.optim import adamw as jax_adamw
    from repro_torch.launch.mesh import spawn_ranks

    jcfg = jax_get_config(arch).reduced()
    s, slots = seq_len(jcfg), 8
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    params_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    rng = np.random.default_rng(7)
    batches = {"slots": slots, "bf16": set()}
    for i, (k, kind) in enumerate([("prefill", "prefill"), ("train", "train")]):
        b = jax_specs.make_batch(jcfg, JaxShape(k, kind, s, BATCH), seed=i)
        batches["bf16"] |= {n for n, v in b.items() if v.dtype == jnp.bfloat16}
        batches[k] = {n: np.asarray(v, np.float32 if v.dtype == jnp.bfloat16 else v.dtype)
                      for n, v in b.items()}
    batches["decode"] = {"tokens": rng.integers(0, jcfg.vocab, (BATCH, 1)).astype(np.int32),
                         "pos": np.array([3, 1, 5, 2], np.int32)}
    cache = jax_api.init_cache(jcfg, BATCH, slots, dtype=jnp.float32)
    batches["cache"] = jax.tree.map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32), cache)
    # the ranks run while the parent computes the reference
    got: list = []
    spawner = threading.Thread(target=lambda: got.append(_spawn(spawn_ranks, arch, params_np,
                                                                batches, train_steps)))
    spawner.start()

    def tree(b):
        return {k: jnp.asarray(v, jnp.bfloat16 if k in batches["bf16"] else v.dtype)
                for k, v in b.items()}

    ref = {"prefill": np.asarray(jax_api.prefill_logits(jparams, jcfg, tree(batches["prefill"]),
                                                        compute_dtype=jnp.float32))}
    step = jax.jit(lambda c, t, p: jax_api.decode_step(jparams, jcfg, c, t, p,
                                                       compute_dtype=jnp.float32))
    c, dec, ticks = jax.tree.map(jnp.asarray, batches["cache"]), tree(batches["decode"]), []
    for i in range(TICKS):
        lg, c = step(c, dec["tokens"] + i, dec["pos"] + i)
        ticks.append(np.asarray(lg))
    ref["decode"] = ticks
    ocfg = jax_adamw.AdamWConfig(**OPT)

    @jax.jit
    def jstep(p, o, batch):
        loss, g = jax.value_and_grad(jax_api.loss_fn)(p, jcfg, batch, remat="none",
                                                      compute_dtype=jnp.float32)
        p, o, st = jax_adamw.apply(g, o, p, ocfg)
        return p, o, loss, st["grad_norm"]

    p, o, losses = jparams, jax_adamw.init(jparams), []
    for _ in range(train_steps):
        p, o, loss, gnorm = jstep(p, o, tree(batches["train"]))
        losses.append((float(loss), float(gnorm)))
    ref["train"] = losses
    ref["params"], ref["params0"] = _by_path(jax, p), _by_path(jax, params_np)
    spawner.join()
    if isinstance(got[0], BaseException):
        raise got[0]
    return got[0], ref


def _by_path(jax, tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v, np.float32) for path, v in flat}


def _spawn(spawn_ranks, *args):
    try:
        return spawn_ranks(_ranks, 4, backend="gloo", timeout=120, join_timeout=300, args=args)
    except BaseException as e:  # re-raised in the test's thread
        return e


def update_errs(rank: dict, ref: dict) -> dict:
    """{leaf: the error of the rank's change over the train steps against the
    reference's change, relative to the largest element of that change}."""
    assert sorted(rank["params"]) == sorted(ref["params"])
    p0 = ref["params0"]
    return {k: err(rank["params"][k] - p0[k], v - p0[k]) for k, v in ref["params"].items()}


def err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / max(np.max(np.abs(want)), 1e-30))

