"""The port's training path (repro_torch: softmax_xent, api.loss_fn and its
gradients under every remat policy, AdamW, the token pipeline, gradient
compression, the checkpoint store, the step builders, the Trainer and the
launcher) against the JAX package's, on the CPU, fp32 unless stated, at
2e-4 (``tests/test_kernels.py::_tol``). Weights come from the JAX
initialisers through ``params_from_jax``; batches, gradients and states are
the same numpy arrays on both sides. The JAX Trainer itself does not run on
this jax (tests/test_runtime.py's trainer tests fail at its mesh), so the
port's Trainer is held to a JAX loop of ``api.loss_fn`` +
``adamw.apply``."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jax_store  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.parallel import collectives as jax_collectives  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer, restore_trainer_state  # noqa: E402
from repro_torch.tree import flatten, leaves, map_tree  # noqa: E402

ARCHS = ["starcoder2-3b", "zamba2-2.7b", "llava-next-34b"]
TOL = 2e-4
SEQ, BATCH = 32, 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _err(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(out).all()
    scale = np.abs(ref).max()
    return float(np.abs(out - ref).max() / scale) if scale else float(np.abs(out).max())


def _batch(cfg, rng) -> dict:
    b = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)}
    if cfg.n_patches:
        b["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.vision_embed_dim)).astype(np.float32)
    return b


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.fixture(scope="module")
def grads_ref():
    """Per arch: the JAX loss and gradients (fp32, no remat) on one batch,
    and the port's config and params."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_get_config(arch).reduced()
            jparams = jax_api.init_params(jax.random.key(0), jcfg)
            b = _batch(jcfg, np.random.default_rng(7))
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jax_api.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
                                          compute_dtype=jnp.float32, remat="none")))(jparams)
            tparams = transformer.params_from_jax(_np_tree(jparams), device="cpu")
            cache[arch] = (get_config(arch).reduced(), tparams, b, float(loss), grads)
        return cache[arch]

    return get


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("outside", [False, True], ids=["in_vocab", "label_outside_vocab"])
def test_softmax_xent_matches_jax(name, outside):
    """A label outside [0, vocab) gives a zero one-hot row in both packages
    (its target logit counts as 0), where F.one_hot would raise."""
    rng = np.random.default_rng(0)
    v = 50
    logits = (rng.standard_normal((2, 6, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, (2, 6))
    if outside:
        labels[0, :3] = [v, v + 7, -1]
    jdt, tdt = (jnp.float32, torch.float32) if name == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    ref = float(jax_transformer.softmax_xent(jnp.asarray(logits, jdt), jnp.asarray(labels)))
    out = transformer.softmax_xent(torch.from_numpy(logits).to(tdt), torch.from_numpy(labels))
    assert out.dtype == torch.float32 and out.dim() == 0
    tol = TOL if name == "float32" else 2e-2
    assert abs(out.item() - ref) <= tol * abs(ref)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_loss_and_grads_match_jax(arch, remat, grads_ref):
    """api.loss_fn's value and every gradient leaf against jax.value_and_grad,
    each remat policy giving the same loss."""
    cfg, tparams, b, jloss, jgrads = grads_ref(arch)
    loss, grads = steps.loss_and_grads(tparams, cfg, _torch_batch(b), remat=remat,
                                       compute_dtype=torch.float32)
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    ref = [(jax.tree_util.keystr(p), g)
           for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    ours = flatten(grads)
    assert len(ours) == len(ref)
    for (key, g), (jkey, jg) in zip(ours, ref):
        assert tuple(g.shape) == jg.shape and g.dtype == torch.float32, key
        assert _err(g.numpy(), jg) <= TOL, (key, jkey)
    none_loss, _ = steps.loss_and_grads(tparams, cfg, _torch_batch(b), remat="none",
                                        compute_dtype=torch.float32)
    assert loss.item() == none_loss.item()


def test_loss_fn_takes_the_plain_route(grads_ref):
    """api.loss_fn runs the plain route under autograd; the kernel route of
    the same forward raises there (the kernels have no backward)."""
    cfg, tparams, b, _, _ = grads_ref("starcoder2-3b")
    params = map_tree(lambda p: p.detach().requires_grad_(), tparams)
    loss = api.loss_fn(params, cfg, _torch_batch(b), compute_dtype=torch.float32)
    loss.backward()
    assert all(p.grad is not None for p in leaves(params))
    with pytest.raises(RuntimeError, match="no backward"):
        api.prefill_logits(params, cfg, _torch_batch(b), compute_dtype=torch.float32)
    with torch.no_grad():
        api.prefill_logits(params, cfg, _torch_batch(b), compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blocks": {"a": rng.standard_normal((3, 4, 4)).astype(np.float32),
                       "s": np.ones((7,), np.float32)}}


def test_adamw_matches_jax_over_steps():
    """Three steps of adamw.apply on identical grads (each clipped: norm > 1),
    through the warmup and the cosine: params, mu, nu, count, grad norm, lr."""
    rng = np.random.default_rng(3)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=4)
    jcfg, tcfg = jax_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    p0 = _adamw_tree(rng)
    jp, jstate = jax.tree.map(jnp.asarray, p0), jax_adamw.init(jax.tree.map(jnp.asarray, p0))
    tp = map_tree(torch.from_numpy, p0)
    tstate = adamw.init(tp)
    assert tstate.count.dtype == torch.int32 and tstate.count.dim() == 0
    for step in range(3):
        g = map_tree(lambda a: (rng.standard_normal(a.shape) * 2).astype(np.float32), p0)
        jp, jstate, jst = jax_adamw.apply(jax.tree.map(jnp.asarray, g), jstate, jp, jcfg)
        tp, tstate, tst = adamw.apply(map_tree(torch.from_numpy, g), tstate, tp, tcfg)
        for ours, ref in ((tp, jp), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            for (key, a), b in zip(flatten(ours), jax.tree.leaves(ref)):
                assert _err(a.numpy(), b) <= TOL, (step, key)
        assert int(tstate.count) == int(jstate.count) == step + 1
        assert abs(tst["grad_norm"].item() - float(jst["grad_norm"])) <= TOL * float(
            jst["grad_norm"])
        assert abs(tst["lr"].item() - float(jst["lr"])) <= TOL * float(jst["lr"])
        assert tst["lr"].dtype == torch.float32


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10000, 12000])
def test_schedule_matches_jax(step):
    cfg = adamw.AdamWConfig()
    ours = adamw.schedule(cfg, torch.tensor(float(step)))
    ref = float(jax_adamw.schedule(jax_adamw.AdamWConfig(), jnp.float32(step)))
    assert ours.dtype == torch.float32
    assert abs(ours.item() - ref) <= 1e-6 * max(abs(ref), 1e-12)


def test_adamw_bf16_params_and_global_norm():
    """A bf16 param leaf updates through fp32 and is cast back, as the
    reference's ``.astype(p.dtype)``; global_norm sums in fp32."""
    rng = np.random.default_rng(4)
    p = rng.standard_normal((8, 8)).astype(np.float32)
    g = rng.standard_normal((8, 8)).astype(np.float32)
    jp = {"h": jnp.asarray(p, jnp.bfloat16)}
    jout, _, jst = jax_adamw.apply({"h": jnp.asarray(g, jnp.bfloat16)}, jax_adamw.init(jp), jp,
                                   jax_adamw.AdamWConfig(lr=1e-1, warmup_steps=0))
    tp = {"h": torch.from_numpy(p).to(torch.bfloat16)}
    tout, _, tst = adamw.apply({"h": torch.from_numpy(g).to(torch.bfloat16)}, adamw.init(tp),
                               tp, adamw.AdamWConfig(lr=1e-1, warmup_steps=0))
    assert tout["h"].dtype == torch.bfloat16
    assert _err(tout["h"].float().numpy(), np.asarray(jout["h"], np.float32)) <= 2e-2
    assert abs(tst["grad_norm"].item() - float(jst["grad_norm"])) <= TOL * float(jst["grad_norm"])


# ---------------------------------------------------------------------------
# data, compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,shard,n_shards", [(0, 0, 0, 1), (3, 17, 2, 4), (1, 5, 1, 2),
                                                      (7, 123, 0, 8)])
def test_token_pipeline_copy_matches(seed, step, shard, n_shards):
    cfg = dict(vocab=512, seq_len=64, global_batch=8, seed=seed)
    a = pipeline.TokenPipeline(pipeline.DataConfig(**cfg)).make(step, shard, n_shards)
    b = jax_pipeline.TokenPipeline(jax_pipeline.DataConfig(**cfg)).make(step, shard, n_shards)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_compress_grads_matches_jax():
    rng = np.random.default_rng(6)
    g = {"w": rng.standard_normal((40, 30)).astype(np.float32),
         "b": {"c": (rng.standard_normal(17) * 1e-3).astype(np.float32)}}
    e = map_tree(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), g)
    jq, je = jax_collectives.compress_grads(jax.tree.map(jnp.asarray, g),
                                            jax.tree.map(jnp.asarray, e))
    tq, te = collectives.compress_grads(map_tree(torch.from_numpy, g),
                                        map_tree(torch.from_numpy, e))
    for (key, a), b in zip(flatten(tq), jax.tree.leaves(jq)):
        assert _err(a.numpy(), b) <= 1e-6, key
    for (key, a), b in zip(flatten(te), jax.tree.leaves(je)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6 * _abs_max(g), key
    q, scale = collectives.quantize_int8(torch.from_numpy(g["w"]))
    jq8, jscale = jax_collectives.quantize_int8(jnp.asarray(g["w"]))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq8))
    assert scale.item() == float(jscale)
    zeros = collectives.init_error_feedback(map_tree(torch.from_numpy, g))
    assert all(z.dtype == torch.float32 and not z.any() for z in leaves(zeros))


def _abs_max(tree) -> float:
    return max(np.abs(a).max() for a in jax.tree.leaves(tree))


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------


def _jax_state(arch="starcoder2-3b"):
    jcfg = jax_get_config(arch).reduced()
    jparams = jax_api.init_params(jax.random.key(1), jcfg)
    jopt = jax_adamw.init(jparams)
    rng = np.random.default_rng(8)
    jopt = jax_adamw.OptState(
        mu=jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
                        jopt.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), jnp.float32), jopt.nu),
        count=jnp.asarray(5, jnp.int32))
    return jcfg, {"params": jparams, "opt": jopt}


def test_checkpoint_jax_to_port_bit_equal(tmp_path):
    jcfg, tree = _jax_state()
    jax_store.save(str(tmp_path), 5, tree, meta={"arch": jcfg.name})
    assert store.latest_step(str(tmp_path)) == 5
    cfg = get_config("starcoder2-3b").reduced()
    like_p = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    out = store.restore(str(tmp_path), 5, {"params": like_p, "opt": adamw.init(like_p)},
                        device="cpu")
    assert isinstance(out["opt"], adamw.OptState)
    ref = jax.tree_util.tree_flatten_with_path(tree)[0]
    ours = flatten(out)
    assert [k for k, _ in ours] == [
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path) for path, _ in ref]
    for (key, a), (_, b) in zip(ours, ref):
        assert a.numpy().dtype == np.asarray(b).dtype, key
        assert np.array_equal(a.numpy(), np.asarray(b)), key
    assert store.meta(str(tmp_path), 5)["meta"]["arch"] == jcfg.name


def test_checkpoint_port_to_jax_bit_equal(tmp_path):
    cfg = get_config("zamba2-2.7b").reduced()
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    opt = adamw.init(params)
    for t in leaves(opt.mu) + leaves(opt.nu):
        t.normal_()
    opt.count.fill_(9)
    store.save(str(tmp_path), 9, {"params": params, "opt": opt}, meta={"arch": cfg.name})
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    out = jax_store.restore(str(tmp_path), 9, {"params": jparams, "opt": jax_adamw.init(jparams)})
    assert int(out["opt"].count) == 9
    ours = flatten({"params": params, "opt": opt})
    ref = jax.tree.leaves(out)
    assert len(ours) == len(ref)
    for (key, a), b in zip(ours, ref):
        assert np.array_equal(a.numpy(), np.asarray(b)), key


def test_checkpoint_bf16_and_torn_manifest(tmp_path):
    """bfloat16 leaves round-trip through their 16-bit words; LATEST naming a
    directory without a manifest and a torn manifest both fall back to the
    newest complete step (tests/test_runtime.py's torn-write case, plus a
    manifest cut mid-write)."""
    d = str(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": torch.randn(5, dtype=torch.float32).to(torch.bfloat16),
            "lst": [torch.zeros(2), torch.full((3,), 7, dtype=torch.int32)]}
    for s in (1, 2, 4):
        store.save(d, s, tree)
    with open(os.path.join(d, "step_00000004", "manifest.json"), "w") as f:
        f.write('{"step": ')
    os.makedirs(os.path.join(d, "step_00000003"))
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("step_00000003")
    assert store.latest_step(d) == 2
    out = store.restore(d, 2, map_tree(torch.zeros_like, tree))
    for (key, a), b in zip(flatten(out), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), key
    assert store.latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# steps, Trainer, launcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_setup():
    return get_config("starcoder2-3b").reduced(), ShapeSpec("t", "train", 64, 4)


def test_trainer_loss_decreases(tiny_setup, tmp_path):
    cfg, shape = tiny_setup
    tr = Trainer(cfg, shape, TrainConfig(steps=12, ckpt_every=100, ckpt_dir=str(tmp_path),
                                         log_every=100), device="cpu")
    tr.run()
    first = np.mean([s["loss"] for s in tr.stats[:3]])
    last = np.mean([s["loss"] for s in tr.stats[-3:]])
    assert last < first, f"loss did not decrease: {first} -> {last}"


def test_trainer_failure_injection_recovers(tiny_setup, tmp_path):
    cfg, shape = tiny_setup
    tr = Trainer(cfg, shape, TrainConfig(steps=8, ckpt_every=2, ckpt_dir=str(tmp_path),
                                         log_every=100), device="cpu")
    tr.fail_at(5)
    tr.run()
    assert tr.step == 8
    assert tr._restarts == 1
    assert {s["step"] for s in tr.stats} == set(range(8))


def test_trainer_resume_from_checkpoint(tiny_setup, tmp_path):
    cfg, shape = tiny_setup
    t1 = Trainer(cfg, shape, TrainConfig(steps=4, ckpt_every=4, ckpt_dir=str(tmp_path),
                                         log_every=100), device="cpu")
    p1, o1 = t1.run()
    t2 = Trainer(cfg, shape, TrainConfig(steps=8, ckpt_every=4, ckpt_dir=str(tmp_path),
                                         log_every=100), device="cpu")
    p2, o2 = restore_trainer_state(t2, 4)
    for a, b in zip(leaves({"p": p1, "o": o1}), leaves({"p": p2, "o": o2})):
        assert torch.equal(a, b)
    t2.run()
    assert min(s["step"] for s in t2.stats) == 4


def test_trainer_resumed_from_jax_checkpoint_follows_jax_loop(tmp_path):
    """A step-0 checkpoint written by JAX's store from JAX-initialised params
    and state; the port's Trainer (fp32 compute) resumes from it and its
    per-step losses and grad norms follow a JAX loop of api.loss_fn +
    adamw.apply on the same 6 batches within 2e-4."""
    n, shape = 6, ShapeSpec("t", "train", 32, 2)
    jcfg = jax_get_config("starcoder2-3b").reduced()
    jparams = jax_api.init_params(jax.random.key(4), jcfg)
    jopt = jax_adamw.init(jparams)
    jax_store.save(str(tmp_path), 0, {"params": jparams, "opt": jopt})
    ocfg = jax_adamw.AdamWConfig(total_steps=n)
    data = jax_pipeline.TokenPipeline(jax_pipeline.DataConfig(
        vocab=jcfg.vocab, seq_len=shape.seq_len, global_batch=shape.global_batch, seed=0))

    @jax.jit
    def jstep(p, o, batch):
        loss, g = jax.value_and_grad(jax_api.loss_fn)(p, jcfg, batch, remat="none",
                                                      compute_dtype=jnp.float32)
        p, o, st = jax_adamw.apply(g, o, p, ocfg)
        return p, o, loss, st["grad_norm"]

    ref = []
    for s in range(n):
        jparams, jopt, loss, gnorm = jstep(jparams, jopt,
                                           {k: jnp.asarray(v) for k, v in data.make(s).items()})
        ref.append((float(loss), float(gnorm)))

    tr = Trainer(get_config("starcoder2-3b").reduced(), shape,
                 TrainConfig(steps=n, ckpt_every=100, ckpt_dir=str(tmp_path), log_every=100,
                             compute_dtype="float32"), device="cpu")
    tr.run()
    assert [s["step"] for s in tr.stats] == list(range(n))
    for s, (loss, gnorm) in zip(tr.stats, ref):
        assert abs(s["loss"] - loss) <= TOL * abs(loss), s
        assert abs(s["grad_norm"] - gnorm) <= TOL * abs(gnorm), s


def test_build_step_kinds_on_cpu(tiny_setup):
    cfg, _ = tiny_setup
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, generator=gen, device="cpu")
    before = {k: v.clone() for k, v in flatten(params)}
    opt = adamw.init(params)
    data = pipeline.TokenPipeline(pipeline.DataConfig(cfg.vocab, 16, 2))
    batch = {k: torch.from_numpy(v).long() for k, v in data.make(0).items()}
    train = steps.build_step(cfg, ShapeSpec("s", "train", 16, 2), device="cpu")
    loss0, _ = steps.loss_and_grads(params, cfg, batch, remat="none")
    out, opt2, loss, gnorm = train(params, opt, batch)
    assert out is params and opt2 is opt and int(opt.count) == 1
    assert loss.item() == loss0.item() and torch.isfinite(gnorm)
    assert all(not torch.equal(v, before[k]) for k, v in flatten(params))
    assert all(not p.requires_grad for p in leaves(params))
    logits = steps.build_step(cfg, ShapeSpec("p", "prefill", 16, 2), device="cpu")(params, batch)
    assert logits.shape == (2, 16, cfg.vocab)
    cache = api.init_cache(cfg, 2, 4, device="cpu")
    dec = steps.build_step(cfg, ShapeSpec("d", "decode", 4, 2), device="cpu")
    lg, cache = dec(params, cache, batch["tokens"][:, :1], torch.zeros(2, dtype=torch.long))
    assert lg.shape == (2, cfg.vocab)
    bf = steps.build_step(cfg, ShapeSpec("s", "train", 16, 2), device="cpu",
                          opts=steps.StepOptions(remat="dots", cast_params=True))
    bf(params, opt, batch)
    assert all(p.dtype == torch.float32 for p in leaves(params)) and int(opt.count) == 2


def test_constrain_grads_raises(tiny_setup):
    cfg, shape = tiny_setup
    with pytest.raises(NotImplementedError, match="item 11"):
        steps.build_step(cfg, shape, device="cpu", opts=steps.OPTIMIZED)


@pytest.mark.parametrize("name", ["conv2d", "matmul", "rmsnorm", "flash_attention", "ssd"])
def test_kernel_wrappers_refuse_grad(name):
    """Each kernel wrapper raises when autograd would record it (its kernel
    has no backward); under no_grad, or with no input requiring grad, it
    runs."""
    import importlib
    fn = getattr(importlib.import_module(f"repro_torch.kernels.{name}.ops"), name)
    r = lambda *s: torch.randn(*s)  # noqa: E731
    args = {"conv2d": (r(1, 4, 6, 6), r(8, 4, 3, 3)), "matmul": (r(4, 8), r(8, 6)),
            "rmsnorm": (r(3, 16), torch.ones(16)),
            "flash_attention": (r(1, 8, 2, 16), r(1, 8, 1, 16), r(1, 8, 1, 16)),
            "ssd": (r(1, 8, 2, 4), torch.rand(1, 8, 2), torch.zeros(2), r(1, 8, 4), r(1, 8, 4))}
    kw = {"ssd": {"chunk": 4}}.get(name, {})
    plain = fn(*args[name], **kw)
    grad_args = [a.clone().requires_grad_() for a in args[name]]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*grad_args, **kw)
    with torch.no_grad():
        torch.testing.assert_close(fn(*grad_args, **kw), plain)


def test_launcher_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    d = str(tmp_path / "ckpt")
    train.main(["--arch", "starcoder2-3b", "--reduced", "--steps", "3", "--batch", "2",
                "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 3 steps, loss " in out and "stragglers=" in out
    assert store.latest_step(d) == 3 and sorted(os.listdir(d)) == [
        "LATEST", "step_00000002", "step_00000003"]
    cfg = get_config("starcoder2-3b").reduced()
    like = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tree = store.restore(d, 3, {"params": like, "opt": adamw.init(like)})
    assert int(tree["opt"].count) == 3
    with np.load(os.path.join(d, "step_00000003", "arrays.npz")) as z:
        for key, t in flatten(tree):
            assert np.array_equal(t.numpy(), z[key]), key
    # run again at --steps: no step, no crash (the reference's launcher raises there)
    train.main(["--arch", "starcoder2-3b", "--reduced", "--steps", "3", "--batch", "2",
                "--seq", "16", "--ckpt-dir", d, "--device", "cpu"])
    assert "done: 0 steps, the checkpoint in" in capsys.readouterr().out
