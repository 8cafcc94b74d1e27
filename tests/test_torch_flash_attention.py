"""The port's flash attention (repro_torch.kernels.flash_attention) against
the JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py
runs it), its oracle ``attention_ref`` and ``layers.gqa_attention``, on the
same numpy inputs. On the CPU the port's wrappers take their plain version;
the CUDA kernel itself is checked by the ``cuda``-marked cases."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.ops import attn_fn, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models.layers import gqa_attention  # noqa: E402

ATTN_CASES = [  # tests/test_kernels.py::ATTN_CASES: (b, s, h, kv, hd, causal, window)
    (1, 128, 4, 2, 64, True, None),
    (2, 96, 4, 4, 32, True, None),       # ragged seq len
    (1, 256, 8, 2, 64, True, 64),        # sliding window
    (1, 64, 2, 2, 64, False, None),      # bidirectional (whisper encoder)
    (1, 128, 6, 2, 48, True, None),      # non-pow2 head count/dim
]
# Queries at the end of a longer key timeline (S < Sk, as in chunked
# prefill): (b, s, s_k, h, kv, hd, window).
SHORT_Q_CASES = [(2, 40, 100, 4, 2, 32, None), (1, 70, 200, 6, 2, 48, 64)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jax():
    """JAX is imported here, not at the top: the machine with the card has
    none, and the ``cuda`` cases below must still run there."""
    return pytest.importorskip("jax")


def _tol(name):  # tests/test_kernels.py::_tol
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-4, rtol=2e-4)


def _inputs(b, s, s_k, h, kv, hd, name, seed=0):
    """q, k, v as numpy float32 holding values exact in the dtype, and as tensors."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DTYPES[name])
          for shape in ((b, s, h, hd), (b, s_k, kv, hd), (b, s_k, kv, hd))]
    return [t.float().numpy() for t in ts], ts


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_flash_attention_matches_jax(case, name, jax):
    from repro.kernels.flash_attention.ops import flash_attention as jax_flash
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    b, s, h, kv, hd, causal, win = case
    (q, k, v), (qt, kt, vt) = _inputs(b, s, s, h, kv, hd, name)
    qj, kj, vj = (jax.numpy.asarray(a, name) for a in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal, window=win)
    assert out.dtype == DTYPES[name] and out.shape == (b, s, h, hd)
    pallas = jax_flash(qj, kj, vj, causal=causal, window=win, bq=32, bk=32)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(pallas, np.float32), **_tol(name))
    np.testing.assert_allclose(
        attention_ref(qt, kt, vt, causal=causal, window=win).float().numpy(),
        np.asarray(jax_ref(qj, kj, vj, causal=causal, window=win), np.float32), **_tol(name))


@pytest.mark.parametrize("case", SHORT_Q_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_flash_attention_short_queries_match_ref(case, name, jax):
    """S < Sk: the queries sit at positions Sk - S .. Sk - 1, as attention_ref
    aligns them (the Pallas kernel would start them at 0)."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    b, s, s_k, h, kv, hd, win = case
    (q, k, v), (qt, kt, vt) = _inputs(b, s, s_k, h, kv, hd, name)
    ref = jax_ref(*(jax.numpy.asarray(a, name) for a in (q, k, v)), causal=True, window=win)
    out = flash_attention(qt, kt, vt, causal=True, window=win)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **_tol(name))


@pytest.mark.parametrize("hook", [False, True])
def test_gqa_attention_matches_jax(hook, jax):
    """gqa_attention with and without the kernel hook against the JAX
    package's gqa_attention (tests/test_kernels.py:59)."""
    from repro.models.layers import gqa_attention as jax_gqa, init_attention
    d, h, kv = 64, 4, 2
    params = init_attention(jax.random.key(0), d, h, kv)
    x = np.random.default_rng(1).standard_normal((2, 32, d)).astype(np.float32)
    ref = np.asarray(jax_gqa(jax.numpy.asarray(x), params, h, kv, rope=True))
    tparams = {n: torch.from_numpy(np.array(w)) for n, w in params.items()}
    out = gqa_attention(torch.from_numpy(x), tparams, h, kv, rope=True,
                        attn_fn=attn_fn if hook else None)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("bad", ["rank", "dtype", "mixed_dtype", "heads", "head_dim",
                                 "device", "noncontiguous", "window"])
def test_flash_attention_rejects(bad):
    q, k, v = torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 2, 16))
    kw = {}
    if bad == "rank":
        q = q[0]
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        v = v.bfloat16()
    elif bad == "heads":
        k, v = torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3, 16))
    elif bad == "head_dim":
        q, k, v = (torch.zeros(t.shape[:3] + (300,)) for t in (q, k, v))
    elif bad == "device":
        k = torch.zeros((1, 8, 2, 16), device="meta")
    elif bad == "noncontiguous":
        q = torch.zeros((1, 4, 8, 16)).transpose(1, 2)
    elif bad == "window":
        kw["window"] = 0
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(b, s, s, h, kv, hd, c, w) for b, s, h, kv, hd, c, w in ATTN_CASES]
                         + [(b, s, sk, h, kv, hd, True, w)
                            for b, s, sk, h, kv, hd, w in SHORT_Q_CASES]
                         + [(2, 200, 200, 8, 2, 120, True, 64), (1, 300, 300, 2, 1, 256, True, None)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_flash_attention_kernel_matches_plain_on_card(case, name, cuda_device):
    b, s, s_k, h, kv, hd, causal, win = case
    _, ts = _inputs(b, s, s_k, h, kv, hd, name)
    qt, kt, vt = (t.to(cuda_device) for t in ts)
    before = flash_attention.launches
    out = flash_attention(qt, kt, vt, causal=causal, window=win)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(),
                               attention_ref(qt, kt, vt, causal=causal, window=win).float(),
                               **_tol(name))
