"""The dry run's counters (``launch/hlo_stats.py``) and cells
(``launch/dryrun.py``) on the CPU: a fake process group, device type
``cpu``, fake tensors.

* A product of two DTensors counts its local shards, not the global
  product ``FlopCounterMode`` counts.
* Each kernel's registered FLOP formula equals ``FlopCounterMode`` of the
  kernel's plain version at the kernel tests' shapes.
* Unsharded, the port's prefill, decode and train of every family at
  ``.reduced()`` count the FLOPs that ``exact_cost`` parses from the jitted
  JAX function: exactly, and a train step within 1e-3 of it, except the
  xLSTM's, whose scans differentiate differently: that cell's difference
  must equal the one its causes give (``_xlstm_scan_gap``): autograd skips
  the gradients that the zero initial states and the unread last state
  need none of, where XLA transposes every step of a scan alike, and the
  two pair the chunkwise scan's einsums differently. The sequence covers
  two SSM chunks: with one, XLA folds away the products against the zero
  initial state of the SSD and the mLSTM, which the port computes.
* ``run_cell`` writes records the reference's readers take.
"""
import dataclasses
import gc
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShape  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.launch.hlo_cost import exact_cost  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_stats import StepCounter, memory_summary  # noqa: E402
from repro_torch.models import api, recurrent, transformer  # noqa: E402
from repro_torch.parallel.sharding import placements  # noqa: E402
from repro_torch.train import steps  # noqa: E402

FAMILIES = ["starcoder2-3b", "llava-next-34b", "whisper-base", "xlstm-350m", "zamba2-2.7b",
            "kimi-k2-1t-a32b"]
BATCH, TEXT = 4, 64  # two chunks of the reduced SSM configs' 32


def _flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as f:
        fn(*args)
    return f.get_total_flops()


def test_a_sharded_product_counts_the_local_shards():
    with dryrun.fake_world((2, 2), device_type="cpu") as mesh, FakeTensorMode():
        a = distribute_tensor(torch.empty(64, 128), mesh, (Shard(0), Replicate()))
        b = distribute_tensor(torch.empty(128, 128), mesh, (Replicate(), Shard(1)))
        c = StepCounter()
        out = c.run(torch.matmul, a, b)
        assert c.flops == 2 * 32 * 128 * 64 == 524288
        assert tuple(out.to_local().shape) == (32, 64)
        assert _flops(torch.matmul, a, b) == 2 * 64 * 128 * 128  # the global product
        assert c.collective_stats().total_count == 0


def test_collectives_are_counted_by_kind_at_the_result_size():
    with dryrun.fake_world((2, 2), device_type="cpu") as mesh, FakeTensorMode():
        a = distribute_tensor(torch.empty(64, 128), mesh, (Shard(0), Shard(1)))
        c = StepCounter()
        c.run(lambda t: t.full_tensor(), a)
        st = c.collective_stats()
        assert st.count_by_kind["all-gather"] == 2 and st.total_count == 2
        # (32, 64) gathered over model, then (32, 128) over data, in fp32
        assert st.bytes_by_kind["all-gather"] == 4 * (32 * 128 + 64 * 128)
        m = memory_summary(c)
        assert m["argument_size_in_bytes"] == 4 * 32 * 64
        assert m["output_size_in_bytes"] == 4 * 64 * 128 and m["alias_size_in_bytes"] == 0
        assert m["total_per_device"] == (m["argument_size_in_bytes"] + m["output_size_in_bytes"]
                                         + m["temp_size_in_bytes"])


def test_a_collectives_result_counts_once_in_the_peak():
    """Under fake tensors a collective's wait returns a new storage; on a
    device it returns the collective's result: the peak holds it once."""
    with dryrun.fake_world((2, 2), device_type="cpu") as mesh, FakeTensorMode():
        a = distribute_tensor(torch.empty(64, 128), mesh, (Shard(0), Replicate()))
        c = StepCounter()
        c.run(lambda t: t.redistribute(mesh, (Replicate(), Replicate())).to_local(), a)
        assert c.collective_stats().count_by_kind["all-gather"] == 1
        assert c.peak_bytes == 4 * 64 * 128


def test_the_live_bytes_return_to_zero_after_a_step():
    """Every allocation the counter saw is freed once the step's arguments
    and outputs are gone (a storage's address is reused after it is freed,
    while a collective's wait may keep its allocation alive)."""
    cfg, shape = get_config("llama4-maverick-400b-a17b").reduced(), SHAPES["train_4k"]
    with dryrun.fake_world((2, 2), device_type="cpu") as mesh:
        c = dryrun.count_step(cfg, dataclasses.replace(shape, seq_len=128, global_batch=16),
                              mesh, steps.BASELINE)
    gc.collect()
    assert c.peak_bytes > 0 and c.live_bytes == 0


def _loss_grad_peak(mesh_shape, batch: int) -> int:
    with dryrun.fake_world(mesh_shape, device_type="cpu") as mesh, FakeTensorMode():
        dp = tuple(n for n in mesh.mesh_dim_names if n != "model")
        logits = distribute_tensor(torch.empty(batch, 8, 64), mesh,
                                   placements((dp, None, "model"), mesh)).requires_grad_()
        labels = distribute_tensor(torch.zeros(batch, 8, dtype=torch.long), mesh,
                                   placements((dp, None), mesh))
        c = StepCounter()
        with steps.on_mesh(mesh):
            c.run(lambda lg, y: torch.autograd.grad(transformer.softmax_xent(lg, y), lg),
                  logits, labels)
    return c.peak_bytes


def test_the_loss_gradient_peaks_alike_over_one_or_two_batch_dims():
    """The same local shapes, the batch split over (pod, data) or over data
    alone, peak alike: the loss's gradient is pinned to the per-token
    split, so DTensor does not cut a replicated (B, S, V) gradient to it
    one mesh dim at a time (a transient of the batch over pod alone)."""
    assert _loss_grad_peak((2, 2, 2), 16) == _loss_grad_peak((2, 2), 8)


@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (100, 300, 50), (33, 65, 17)])
def test_matmul_formula_counts_the_plain_product(m, k, n):
    a, b = torch.randn(m, k), torch.randn(k, n)
    assert _flops(torch.ops.repro_torch.matmul, a, b, None) == _flops(matmul_ref, a, b) \
        == 2 * m * k * n


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", [(1, 128, 4, 2, 64, True, None),
                                                        (1, 256, 8, 2, 64, True, 64),
                                                        (1, 64, 2, 2, 64, False, None)])
def test_flash_formula_counts_the_plain_attention(b, s, h, kv, hd, causal, window):
    q, k, v = torch.randn(b, s, h, hd), torch.randn(b, s, kv, hd), torch.randn(b, s, kv, hd)
    got = _flops(torch.ops.repro_torch.flash_attention, q, k, v, causal, window)
    assert got == _flops(lambda: attention_ref(q, k, v, causal=causal, window=window)) \
        == 4 * b * h * s * s * hd


@pytest.mark.parametrize("shape", [(2, 16, 64), (4, 7, 48)])
def test_rmsnorm_formula_counts_no_product(shape):
    x, w = torch.randn(shape), torch.randn(shape[-1])
    assert _flops(torch.ops.repro_torch.rmsnorm, x, w, 1e-6) == _flops(rmsnorm_ref, x, w) == 0


@pytest.mark.parametrize("b,s,h,p,n,q", [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64),
                                         (1, 100, 3, 16, 8, 256)])
def test_ssd_formula_counts_the_plain_chunked_scan(b, s, h, p, n, q):
    args = (torch.randn(b, s, h, p), torch.rand(b, s, h), torch.zeros(h), torch.randn(b, s, n),
            torch.randn(b, s, n))
    assert _flops(torch.ops.repro_torch.ssd, *args, q) == _flops(lambda: ssd_ref(*args, q))


def test_wrappers_hand_fake_tensors_to_their_ops():
    """On fake tensors each wrapper returns the op's fake output: nothing runs,
    and the counter reads the op's formula."""
    c = StepCounter()
    with FakeTensorMode():
        a, w = torch.empty(8, 16), torch.empty(16, 4)
        q, kv = torch.empty(1, 32, 4, 16), torch.empty(1, 32, 2, 16)

        def run():
            return (matmul(a, w), rmsnorm(a, torch.empty(16)), flash_attention(q, kv, kv),
                    ssd(torch.empty(1, 32, 2, 8), torch.empty(1, 32, 2), torch.empty(2),
                        torch.empty(1, 32, 4), torch.empty(1, 32, 4), chunk=16))

        outs = c.run(run)
    assert [tuple(o.shape) for o in outs] == [(8, 4), (8, 16), (1, 32, 4, 16), (1, 32, 2, 8)]
    want = 2 * 8 * 16 * 4 + 4 * 4 * 32 * 32 * 16 + 2 * 32 * 16 * 4 + 2 * 32 * 16 * 2 * 8 \
        + 4 * 32 * 2 * 8 * 4
    assert c.flops == want


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
            jp = jax_api.init_params(jax.random.key(0), jcfg)
            tp = transformer.params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                          jp), device="cpu")
            cache[arch] = (jcfg, cfg, jp, tp)
        return cache[arch]

    return get


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            if v.dtype == jnp.bfloat16 else torch.from_numpy(np.array(v)) for k, v in b.items()}


def _xlstm_scan_gap(cfg, b: int, s: int) -> int:
    """The port's train count less ``exact_cost``'s for the xLSTM, from its
    causes (``S`` the chunk, ``hd`` the head width, ``nc`` the chunks):

    * each sLSTM block: the port's first step multiplies the zero initial h,
      which needs no gradient, so autograd skips dh = dg Rᵀ there
      (-2·B·D·4D); XLA's transposed scan takes every step alike;
    * each mLSTM block, in units of the chunk products: autograd skips the
      gradients of the first chunk's products against the zero initial
      state (dC: -2·B·H·S·hd², dn: -2·B·H·S·hd) and of the last chunk's
      state update, which nothing reads (dk and d(v·w): -2 x 2·B·H·S·hd²;
      the n update's dw: -2·B·H·S·hd); XLA transposes every chunk alike.
      The einsums pair differently too: torch takes the rank-1 gradients
      of q·n and of the n update (K = 1) as products, 2·nc - 1 of them,
      XLA as multiplies; XLA takes the state update's gate gradient as a
      product over hd, nc of them, torch as a multiply and a sum. Each is
      2·B·H·S·hd, so the small terms come to (nc - 3)·2·B·H·S·hd.

    Measured equal at (B, S, H) = (4, 64, 4), (2, 96, 4), (2, 128, 2)."""
    d, h, q = cfg.d_model, cfg.n_heads, cfg.ssm.chunk
    hd, nc = d // h, s // q
    n_s = sum(recurrent._is_slstm(cfg, i) for i in range(cfg.n_layers))
    n_m = cfg.n_layers - n_s
    return (n_m * (-3 * 2 * b * h * q * hd * hd + (nc - 3) * 2 * b * h * q * hd)
            - n_s * 2 * b * d * 4 * d)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_unsharded_counts_match_exact_cost(arch, kind, models):
    jcfg, cfg, jp, tp = models(arch)
    s = jcfg.n_patches + TEXT
    c = StepCounter()
    if kind == "decode":
        jc, tc = jax_api.init_cache(jcfg, BATCH, 8), api.init_cache(cfg, BATCH, 8, device="cpu")
        toks, pos = np.zeros((BATCH, 1), np.int32), np.full((BATCH,), 3, np.int32)
        fn = jax.jit(lambda p, c_, t, q: jax_api.decode_step(p, jcfg, c_, t, q))
        ref = exact_cost(fn.lower(jp, jc, toks, pos).compile().as_text()).flops
        with torch.no_grad():
            c.run(api.decode_step, tp, cfg, tc, torch.from_numpy(toks), torch.from_numpy(pos))
    else:
        b = jax_specs.make_batch(jcfg, JaxShape("x", kind, s, BATCH), seed=0)
        if kind == "prefill":
            fn = jax.jit(lambda p, b_: jax_api.prefill_logits(p, jcfg, b_))
            with torch.no_grad():
                c.run(api.prefill_logits, tp, cfg, _torch_batch(b))
        else:
            fn = jax.jit(jax.grad(lambda p, b_: jax_api.loss_fn(p, jcfg, b_)))
            c.run(steps.loss_and_grads, tp, cfg, _torch_batch(b))
        ref = exact_cost(fn.lower(jp, b).compile().as_text()).flops
    if kind == "train" and cfg.family == "ssm":
        assert c.flops - ref == _xlstm_scan_gap(cfg, BATCH, s), (c.flops, ref)
    else:
        assert abs(c.flops - ref) <= (1e-3 * ref if kind == "train" else 0), (c.flops, ref)


@pytest.mark.parametrize("arch,shape", [("starcoder2-3b", "prefill_32k"),
                                        ("llava-next-34b", "train_4k"),
                                        ("whisper-base", "decode_32k"),
                                        ("xlstm-350m", "decode_32k"),
                                        ("zamba2-2.7b", "prefill_32k"),
                                        ("kimi-k2-1t-a32b", "train_4k")])
def test_run_cell_records_feed_the_reference_readers(arch, shape, tmp_path):
    """A reduced cell on a fake (2, 2) mesh: its record has the reference's
    keys, and the reference's readers take it (they take only the production
    meshes, so the test names the record's mesh ``single_pod_16x16``)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks.roofline import roofline_rows
    from repro.calib.measure import hlo_dryrun_measurements

    rec = dryrun.run_cell(arch, shape, False, device_type="cpu", mesh_shape=(2, 2),
                          reduced=True)
    assert rec["status"] == "ok" and rec["n_devices"] == 4 and rec["mesh"] == "2x2"
    assert rec["counted"] == "local shards, rank 0" and rec["device_type"] == "cpu"
    assert set(rec["exact"]) == {"flops", "coll_bytes", "coll_total", "mem_bytes"}
    assert rec["exact"]["flops"] > 0 and rec["collectives"]["total_count"] > 0
    assert rec["cost"]["flops"] == rec["exact"]["flops"]
    assert rec["memory"]["total_per_device"] > rec["memory"]["argument_size_in_bytes"] > 0
    rec["mesh"] = "single_pod_16x16"
    (tmp_path / f"{arch}__{shape}__single.json").write_text(json.dumps(rec))
    rows = roofline_rows([json.loads((tmp_path / f"{arch}__{shape}__single.json").read_text())])
    assert len(rows) == 1 and rows[0]["hlo_flops_per_dev"] == rec["exact"]["flops"]
    ms = hlo_dryrun_measurements(str(tmp_path))
    assert len(ms) == 1 and ms[0].measured_s > 0


def test_run_cell_skips_long_500k_for_full_attention():
    rec = dryrun.run_cell("starcoder2-3b", "long_500k", False, device_type="cpu")
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]
