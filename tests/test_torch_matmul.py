"""The port's matmul (repro_torch.kernels.matmul) against the JAX package's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and its
oracle, on the same numpy inputs. On the CPU the port's wrapper takes its
plain version; the CUDA kernel itself is checked by the ``cuda``-marked
cases, which run only on a machine with a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402

MM_CASES = [(256, 512, 256), (100, 300, 50), (64, 64, 64), (128, 1, 128),
            (33, 65, 17)]  # tests/test_kernels.py::MM_CASES
# A seeded sweep of M, K, N in 1..200 (tests/test_kernels.py's property
# test), with M = 1 (a single decode row) and M = 64 / 65 (either side of
# the kernel's switch between its two tile shapes) written in.
SWEEP = [tuple(int(v) for v in s) for s in np.random.default_rng(7).integers(1, 201, (10, 3))]
SWEEP += [(1, 200, 129), (1, 1, 1), (64, 150, 33), (65, 77, 200)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jnp():
    """JAX is imported here, not at the top: the machine with the card has
    none, and the ``cuda`` cases below must still run there."""
    pytest.importorskip("jax")
    import jax.numpy
    return jax.numpy


def _tol(name):  # tests/test_kernels.py::test_matmul_matches_ref
    return dict(atol=1e-2, rtol=1e-2) if name == "bfloat16" else dict(atol=1e-3, rtol=1e-4)


def _inputs(mkn, name, seed=0):
    """a, b as numpy float32 holding values exact in the dtype, and as tensors."""
    m, k, n = mkn
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(DTYPES[name])
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(DTYPES[name])
    return a.float().numpy(), b.float().numpy(), a, b


@pytest.mark.parametrize("mkn", MM_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_matmul_matches_jax(mkn, name, jnp):
    from repro.kernels.matmul.ops import matmul as jax_matmul
    from repro.kernels.matmul.ref import matmul_ref as jax_matmul_ref
    a, b, at, bt = _inputs(mkn, name)
    aj, bj = jnp.asarray(a, name), jnp.asarray(b, name)
    out = matmul(at, bt)
    assert out.dtype == DTYPES[name] and out.shape == (mkn[0], mkn[2])
    pallas = np.asarray(jax_matmul(aj, bj, bm=64, bn=64, bk=128), np.float32)
    np.testing.assert_allclose(out.float().numpy(), pallas, **_tol(name))
    np.testing.assert_allclose(matmul_ref(at, bt).float().numpy(),
                               np.asarray(jax_matmul_ref(aj, bj), np.float32), **_tol(name))


@pytest.mark.parametrize("mkn", SWEEP)
def test_matmul_sweep_matches_jax(mkn, jnp):
    from repro.kernels.matmul.ops import matmul as jax_matmul
    a, b, at, bt = _inputs(mkn, "float32", seed=sum(mkn))
    pallas = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b), bm=32, bn=32, bk=64))
    np.testing.assert_allclose(matmul(at, bt).numpy(), pallas, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name", list(DTYPES))
def test_matmul_out_dtype(name):
    """out_dtype sets the result's type; the sums are fp32 either way."""
    a, b, at, bt = _inputs((33, 65, 17), name)
    other = torch.float32 if name == "bfloat16" else torch.bfloat16
    out = matmul(at, bt, out_dtype=other)
    assert out.dtype == other
    torch.testing.assert_close(out, torch.from_numpy(a @ b).to(other), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("bad", ["rank", "dtype", "mixed_dtype", "out_dtype", "device",
                                 "inner", "noncontiguous", "empty"])
def test_matmul_rejects(bad):
    a, b = torch.zeros((4, 8)), torch.zeros((8, 3))
    kw = {}
    if bad == "rank":
        a = a[None]
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "mixed_dtype":
        b = b.bfloat16()
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.float16
    elif bad == "device":
        b = torch.zeros((8, 3), device="meta")
    elif bad == "inner":
        b = torch.zeros((9, 3))
    elif bad == "noncontiguous":
        b = torch.zeros((3, 8)).t()
    elif bad == "empty":
        a, b = torch.zeros((0, 8)), torch.zeros((8, 3))
    with pytest.raises(ValueError):
        matmul(a, b, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", MM_CASES + SWEEP + [(4, 3072, 3072), (300, 3072, 256)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_matmul_kernel_matches_plain_on_card(mkn, name, cuda_device):
    _, _, at, bt = _inputs(mkn, name)
    at, bt = at.to(cuda_device), bt.to(cuda_device)
    before = matmul.launches
    out = matmul(at, bt)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    ref = matmul_ref(at, bt).float()
    tol = 2e-2 if name == "bfloat16" else 2e-4  # tests/test_kernels.py::_tol
    if mkn[1] >= 1024:  # large K: hold the error to the output's scale
        err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        assert err <= tol, err
    else:
        torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
