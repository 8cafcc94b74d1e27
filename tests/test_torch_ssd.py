"""The port's SSD chunked scan (repro_torch.kernels.ssd and models.ssm)
against the JAX package's: ``ssd_chunked`` and the Pallas ``ops.ssd`` in
interpret mode, on the same numpy inputs. On the CPU the port's wrapper
takes its plain version; the CUDA kernel itself is checked by the
``cuda``-marked cases. Tolerances: normalised max|d|/max|ref| at 1e-5 in
fp32 (tests/test_kernels.py::test_ssd_matches_chunked_ref), 2e-2 in bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ops import ssd as jax_ssd  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import _segsum, ssd_chunked, ssd_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

# tests/test_kernels.py::SSD_CASES (B, S, H, P, N, chunk), plus S < chunk
# (q = S = 100, not a multiple of the kernel's 64-row tiles).
SSD_CASES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 64, 16),
             (1, 100, 3, 16, 8, 256)]
# Zamba2-2.7B's prefill shape (batch 4 x 512, 80 heads of 64, N = 64, chunk
# 256) and ragged chunks.
CARD_CASES = SSD_CASES + [(4, 512, 80, 64, 64, 256), (2, 300, 4, 24, 40, 100)]


def _inputs(case, seed=0):
    b_, s, h, p, n, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b_, s, h, p)).astype(np.float32) * 0.5,
            rng.uniform(0.1, 1.0, (b_, s, h)).astype(np.float32),
            rng.uniform(-1, 0.5, (h,)).astype(np.float32),
            rng.standard_normal((b_, s, n)).astype(np.float32) * 0.3,
            rng.standard_normal((b_, s, n)).astype(np.float32) * 0.3)


def _err(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _torch(arrays, dtype=torch.float32):
    x, dt, a_log, b, c = (torch.from_numpy(a) for a in arrays)
    return x.to(dtype), dt, a_log, b.to(dtype), c.to(dtype)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_matches_jax(case):
    arrays = _inputs(case)
    chunk = case[-1]
    ref = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk)
    pallas = jax_ssd(*(jnp.asarray(a) for a in arrays), chunk=chunk)
    before = ssd.launches
    out = ssd(*_torch(arrays), chunk=chunk)
    assert ssd.launches == before  # a CPU tensor takes the plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == case[:4]
    assert _err(out, ref) <= 1e-5
    assert _err(out, pallas) <= 1e-5
    assert _err(ssd_ref(*_torch(arrays), chunk=chunk), ref) <= 1e-5


@pytest.mark.parametrize("case", SSD_CASES[:2])
def test_ssd_bf16_matches_compiled_jax(case):
    """bf16 x, b, c and fp32 dt, as the model calls it. Compiled, the JAX
    reference keeps C B^T in fp32; the port does so always."""
    arrays = _inputs(case)
    chunk = case[-1]
    x, dt, a_log, b, c = (jnp.asarray(a) for a in arrays)
    ref = jax.jit(jax_ssm.ssd_chunked, static_argnums=5)(
        x.astype(jnp.bfloat16), dt, a_log, b.astype(jnp.bfloat16), c.astype(jnp.bfloat16), chunk)
    out = ssd(*_torch(arrays, torch.bfloat16), chunk=chunk)
    assert out.dtype == torch.bfloat16
    assert _err(out.float(), ref) <= 2e-2


def test_segsum_matches_jax():
    a = np.random.default_rng(1).standard_normal((2, 3, 16)).astype(np.float32)
    ref = np.asarray(jax_ssm._segsum(jnp.asarray(a)))
    out = _segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[np.isfinite(ref)], ref[np.isfinite(ref)], atol=1e-6)


def test_ssd_chunk_invariance():
    """tests/test_kernels.py::test_ssd_chunk_invariance on the port."""
    arrays = _inputs((1, 128, 2, 16, 8, 0), seed=2)
    arrays = (*arrays[:2], np.zeros(2, np.float32), *arrays[3:])
    o32 = ssd(*_torch(arrays), chunk=32)
    o128 = ssd(*_torch(arrays), chunk=128)
    np.testing.assert_allclose(o32.numpy(), o128.numpy(), atol=1e-4)


def test_ssd_decode_stepped_matches_chunked():
    """tests/test_kernels.py::test_ssd_ref_matches_stepwise_recurrence on the
    port, and each step of the port's ssd_decode against JAX's."""
    b_, s, h, p, n = 1, 32, 2, 8, 4
    x, dt, _, bb, cc = _inputs((b_, s, h, p, n, 0), seed=3)
    a_log = np.random.default_rng(4).uniform(-1, 0.0, (h,)).astype(np.float32)
    arrays = (x, dt, a_log, bb, cc)
    tx, tdt, ta, tb, tc = _torch(arrays)
    ref = ssd_chunked(tx, tdt, ta, tb, tc, 8)
    state = torch.zeros((b_, h, p, n))
    jstate = jnp.zeros((b_, h, p, n), jnp.float32)
    outs = []
    for t in range(s):
        y, state = ssm.ssd_decode(state, tx[:, t], tdt[:, t], ta, tb[:, t], tc[:, t])
        jy, jstate = jax_ssm.ssd_decode(jstate, *(jnp.asarray(a[:, t]) for a in (x, dt)),
                                        jnp.asarray(a_log), jnp.asarray(bb[:, t]),
                                        jnp.asarray(cc[:, t]))
        assert _err(y, jy) <= 1e-5 and _err(state, jstate) <= 1e-5, t
        outs.append(y)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("bad", ["rank", "heads", "dtype", "dt_dtype", "device",
                                 "noncontiguous", "empty", "ragged", "chunk", "wide",
                                 "long_chunk"])
def test_ssd_rejects(bad):
    x, dt, a_log, b, c = _torch(_inputs((1, 64, 2, 16, 8, 32)))
    chunk = 32
    if bad == "rank":
        x = x[0]
    elif bad == "heads":
        a_log = torch.zeros(3)
    elif bad == "dtype":
        b = b.to(torch.bfloat16)
    elif bad == "dt_dtype":
        dt = dt.double()
    elif bad == "device":
        a_log = torch.zeros(2, device="meta")
    elif bad == "noncontiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "empty":
        x, dt, b, c = x[:, :0], dt[:, :0], b[:, :0], c[:, :0]
    elif bad == "ragged":
        chunk = 48  # 64 % 48 != 0
    elif bad == "chunk":
        chunk = 0
    elif bad == "wide":
        b = c = torch.zeros((1, 64, 65))  # N past the kernel's 64
    elif bad == "long_chunk":  # more chunk rows than a block's shared memory holds
        x, dt, b, c = (t.repeat(1, 293, *[1] * (t.dim() - 2)) for t in (x, dt, b, c))
        chunk = 64 * 293
    with pytest.raises(ValueError):
        ssd(x, dt, a_log, b, c, chunk=chunk)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_on_card(case, name, cuda_device):
    dtype = getattr(torch, name)
    x, dt, a_log, b, c = (t.to(cuda_device) for t in _torch(_inputs(case), dtype))
    chunk = case[-1]
    before = ssd.launches
    out = ssd(x, dt, a_log, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    ref = ssd_ref(x, dt, a_log, b, c, chunk=chunk)
    assert _err(out.float().cpu(), ref.float().cpu()) <= (1e-5 if name == "float32" else 2e-2)
