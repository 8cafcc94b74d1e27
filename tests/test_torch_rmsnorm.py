"""The port's RMSNorm (repro_torch.kernels.rmsnorm) against the JAX
package's Pallas kernel (interpret mode) and ``layers.rms_norm``, on the
same numpy inputs. On the CPU the port's wrapper takes its plain version
and the plan that cuts rows for the kernel is checked; the CUDA kernel
itself is checked by the ``cuda``-marked cases."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rmsnorm import rmsnorm as launcher  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402

# tests/test_serving.py::test_rmsnorm_kernel_matches_ref, plus StarCoder2-3B's width
SHAPES = [(2, 16, 64), (1, 100, 128), (4, 7, 48), (2, 7, 3072)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jnp():
    pytest.importorskip("jax")
    import jax.numpy
    return jax.numpy


def _tol(name):  # tests/test_serving.py: 2e-2 in bf16, 1e-5 in fp32
    t = 2e-2 if name == "bfloat16" else 1e-5
    return dict(atol=t, rtol=t)


def _inputs(shape, name, scale_name=None):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DTYPES[name])
    s = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32))
    s = s.to(DTYPES[scale_name or name])
    return x.float().numpy(), s.float().numpy(), x, s


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_rmsnorm_matches_jax(shape, name, jnp):
    from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
    from repro.models.layers import rms_norm as jax_rms_norm
    x, s, xt, st = _inputs(shape, name)
    xj, sj = jnp.asarray(x, name), jnp.asarray(s, name)
    out = rmsnorm(xt, st)
    assert out.dtype == DTYPES[name] and out.shape == shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jax_rmsnorm(xj, sj, bm=32), np.float32), **_tol(name))
    np.testing.assert_allclose(rms_norm(xt, {"scale": st}).float().numpy(),
                               np.asarray(jax_rms_norm(xj, {"scale": sj}), np.float32),
                               **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
def test_rmsnorm_scale_in_other_dtype(name, jnp):
    """fp32 weights normalise bf16 activations (and the reverse), as in a
    model whose params and compute dtypes differ."""
    from repro.models.layers import rms_norm as jax_rms_norm
    other = "float32" if name == "bfloat16" else "bfloat16"
    x, s, xt, st = _inputs((3, 5, 96), name, other)
    out = rmsnorm(xt, st)
    assert out.dtype == DTYPES[name]
    ref = jax_rms_norm(jnp.asarray(x, name), {"scale": jnp.asarray(s, other)})
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **_tol(name))


def test_rms_norm_routes():
    """layers.rms_norm is rmsnorm_ref; with use_kernel on a CPU tensor the
    wrapper takes that same plain version and launches nothing."""
    _, _, xt, st = _inputs((2, 4, 32), "float32")
    before = rmsnorm.launches
    torch.testing.assert_close(rms_norm(xt, {"scale": st}, use_kernel=True),
                               rmsnorm_ref(xt, st), rtol=0, atol=0)
    assert rmsnorm.launches == before


# Widths of the register route's plan: odd (scalar loads), narrow (several
# rows a warp), the LMs' (StarCoder2-3B 3072, Zamba2-2.7B 2560 and 5120), and
# the widest each dtype holds in registers, then past it (the shared route).
PLAN_WIDTHS = [1, 3, 7, 8, 48, 64, 100, 1000, 2560, 3072, 5120, 8192, 8196, 16384, 16392, 20000]


@pytest.mark.parametrize("d", PLAN_WIDTHS)
@pytest.mark.parametrize("name", list(DTYPES))
def test_rmsnorm_plan_covers_each_value_once(d, name):
    """Thread t of a row holds vectors k * tpr + t (k < vpt) of 16 bytes: the
    plan covers the row, every value once, within the kernel's shapes (vpt in
    1, 2, 4; tpr a power of two up to 32 or whole warps; at most 512 threads
    a block, and 256 for blocks of several rows)."""
    dtype = DTYPES[name]
    v = 16 // dtype.itemsize
    p = launcher.plan(d, dtype, True)
    if -(-d // v) > launcher.MAX_TPR * launcher.MAX_VPT:
        assert p.route == "shared"
        return
    assert p.route == "registers" and p.vec == (d % v == 0)
    assert p.vpt in (1, 2, 4)
    assert (p.tpr <= 32 and p.tpr & (p.tpr - 1) == 0) or p.tpr % 32 == 0
    assert p.tpr * p.rows <= launcher.MAX_TPR
    assert p.rows == max(1, launcher.BLOCK_THREADS // p.tpr)
    k, t, e = np.meshgrid(np.arange(p.vpt), np.arange(p.tpr), np.arange(v), indexing="ij")
    held = ((k * p.tpr + t) * v + e).ravel()
    assert sorted(held[held < d]) == list(range(d))
    need = -(-(-(-d // v)) // p.tpr)  # ceil(ceil(d / v) / tpr)
    assert p.vpt == need or (p.vpt, need) == (4, 3)  # the fewest vectors a thread, 3 as 4


def test_rmsnorm_plan_lm_widths():
    """The LMs' widths in bf16 are cut into whole vectors: 96 threads a row at
    D = 2560 and 3072 (two rows a block), 160 at 5120; unaligned storage
    keeps the cut and loads by scalars."""
    plan = launcher.plan
    assert plan(3072, torch.bfloat16, True) == ("registers", 4, 96, 2, True)
    assert plan(2560, torch.bfloat16, True) == ("registers", 4, 96, 2, True)
    assert plan(5120, torch.bfloat16, True) == ("registers", 4, 160, 1, True)
    assert plan(5120, torch.float32, True) == ("registers", 4, 320, 1, True)
    assert plan(3072, torch.bfloat16, False) == ("registers", 4, 96, 2, False)
    x = torch.zeros((3, 3072), dtype=torch.bfloat16)
    s = torch.zeros(3072, dtype=torch.float32)
    assert launcher.plan_for(x, s, torch.empty_like(x)).vec
    shifted = torch.zeros(3 * 3072 + 1, dtype=torch.bfloat16)[1:].view(3, 3072)
    assert not launcher.plan_for(shifted, s, torch.empty_like(x)).vec


@pytest.mark.parametrize("bad", ["scale_shape", "dtype", "device", "noncontiguous", "empty"])
def test_rmsnorm_rejects(bad):
    x, s = torch.zeros((4, 8)), torch.ones(8)
    if bad == "scale_shape":
        s = torch.ones(7)
    elif bad == "dtype":
        x = x.double()
    elif bad == "device":
        s = torch.ones(8, device="meta")
    elif bad == "noncontiguous":
        x = torch.zeros((8, 4)).t()
        s = torch.ones(4)
    elif bad == "empty":
        x = torch.zeros((0, 8))
    with pytest.raises(ValueError):
        rmsnorm(x, s)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2048, 3072), (4, 1, 3072), (3, 20000)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_rmsnorm_kernel_matches_plain_on_card(shape, name, cuda_device):
    _, _, xt, st = _inputs(shape, name)
    xt, st = xt.to(cuda_device), st.to(cuda_device)
    before = rmsnorm.launches
    out = rmsnorm(xt, st)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    torch.testing.assert_close(out.float(), rmsnorm_ref(xt, st).float(), **_tol(name))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 7, 48, 2560, 3072, 5120, 20000])
@pytest.mark.parametrize("rows", [1, 4, 2048])
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("scale", ["same", "other"])
def test_rmsnorm_kernel_widths_on_card(d, rows, name, scale, cuda_device):
    """Every route and cut of the plan (scalar loads at D = 3 and 7, several
    rows a warp at 48, whole warps at the LMs' widths, the shared route at
    20000), with the scale in x's dtype or the other one; a row slice that
    is not 16-byte aligned takes scalar loads."""
    other = "float32" if name == "bfloat16" else "bfloat16"
    _, _, xt, st = _inputs((rows + 1, d), name, other if scale == "other" else name)
    xt, st = xt.to(cuda_device), st.to(cuda_device)
    for x in (xt[:rows], xt[1:]):  # the second starts D values in: aligned iff D % 8 == 0
        before = rmsnorm.launches
        out = rmsnorm(x, st)
        torch.cuda.synchronize()
        assert rmsnorm.launches == before + 1
        torch.testing.assert_close(out.float(), rmsnorm_ref(x, st).float(), **_tol(name))
