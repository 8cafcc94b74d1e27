"""The port's direct conv (repro_torch.kernels.conv2d) against the JAX
package's Pallas kernel (interpret mode, as tests/test_kernels.py runs it)
and its lax oracle, on the same numpy inputs. On the CPU the port's wrapper
takes its plain version; the CUDA kernel itself is checked by the
``cuda``-marked case, which runs only on a machine with a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402

# (N, C, H, W, K, R): tests/test_kernels.py::CONV_CASES plus an even R,
# whose "same" padding is uneven ((R-1)//2 before, R//2 after).
CONV_CASES = [(1, 16, 16, 16, 32, 3), (2, 3, 20, 24, 64, 5),
              (1, 8, 10, 10, 16, 1), (1, 64, 7, 9, 8, 7), (1, 12, 9, 11, 24, 4)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jnp():
    """JAX is imported here, not at the top: the machine with the card has
    none, and the ``cuda`` case below must still run there."""
    pytest.importorskip("jax")
    import jax.numpy
    return jax.numpy


def _tol(name):  # tests/test_kernels.py::_tol
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-4, rtol=2e-4)


def _inputs(case, name, seed=0):
    """x, w as numpy float32 holding values exact in the dtype, and as tensors."""
    n, c, h, w, k, r = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    wt = (rng.standard_normal((k, c, r, r)) * 0.1).astype(np.float32)
    xt, wtt = (torch.from_numpy(a).to(DTYPES[name]) for a in (x, wt))
    return xt.float().numpy(), wtt.float().numpy(), xt, wtt


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_conv2d_matches_jax(case, name, jnp):
    from repro.kernels.conv2d.ops import conv2d as jax_conv2d
    from repro.kernels.conv2d.ref import conv2d_ref as jax_conv2d_ref
    x, w, xt, wt = _inputs(case, name)
    xj, wj = jnp.asarray(x, name), jnp.asarray(w, name)
    out = conv2d(xt, wt)
    assert out.dtype == DTYPES[name]
    assert out.shape == (case[0], case[4], case[2], case[3])
    pallas = np.asarray(jax_conv2d(xj, wj, bk=16), np.float32)
    np.testing.assert_allclose(out.float().numpy(), pallas, **_tol(name))
    np.testing.assert_allclose(conv2d_ref(xt, wt).float().numpy(),
                               np.asarray(jax_conv2d_ref(xj, wj), np.float32),
                               **_tol(name))


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "channels", "noncontiguous",
                                 "rank"])
def test_conv2d_rejects(bad):
    x = torch.zeros((1, 4, 6, 6))
    w = torch.zeros((8, 4, 3, 3))
    if bad == "dtype":
        x, w = x.double(), w.double()
    elif bad == "mixed_dtype":
        w = w.bfloat16()
    elif bad == "channels":
        w = torch.zeros((8, 5, 3, 3))
    elif bad == "noncontiguous":
        x = torch.zeros((1, 6, 6, 4)).permute(0, 3, 1, 2)
    elif bad == "rank":
        x = x[0]
    with pytest.raises(ValueError):
        conv2d(x, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_conv2d_kernel_matches_plain_on_card(case, name, cuda_device):
    _, _, xt, wt = _inputs(case, name)
    xt, wt = xt.to(cuda_device), wt.to(cuda_device)
    before = conv2d.launches
    out = conv2d(xt, wt)
    torch.cuda.synchronize()
    assert conv2d.launches == before + 1
    torch.testing.assert_close(out.float(), conv2d_ref(xt, wt).float(), **_tol(name))
