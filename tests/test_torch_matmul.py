"""The port's matmul (repro_torch.kernels.matmul) against the JAX package's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and its
oracle, on the same numpy inputs. On the CPU the port's wrapper takes its
plain version; the CUDA kernel itself is checked by the ``cuda``-marked
cases, which run only on a machine with a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.matmul import matmul as launcher  # noqa: E402
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
H100_SMS = 132
# (K, N) of every product of the two LMs the port serves, as chip_smoke.py's
# lm_products lists them: StarCoder2-3B (q, k/v, o, up, down, head) and
# Zamba2-2.7B (attention, MLP, Mamba2 in_proj, bc_proj, dt_proj, out_proj,
# head).
LM_SHAPES = [(3072, 3072), (3072, 256), (3072, 12288), (12288, 3072), (3072, 49152),
             (2560, 2560), (2560, 10240), (10240, 2560), (2560, 128), (2560, 80),
             (5120, 2560), (2560, 32000)]


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


# ---------------------------------------------------------------------------
# The plan: route, tile and K splits, decided in Python (no card needed)
# ---------------------------------------------------------------------------

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("mkn, dtype, aligned, route, tile", [
    ((2048, 3072, 3072), BF16, True, "wgmma", "128x128"),
    ((2048, 3072, 3072), FP32, True, "tf32x3", "128x128"),  # fp32 split into TF32 halves
    ((2048, 4100, 201), FP32, False, "tf32x3", "128x128"),  # whatever the alignment
    ((2048, 4104, 200), BF16, True, "wgmma", "128x128"),  # K % 8 == 0, N % 8 == 0
    ((2048, 4100, 200), BF16, True, "simt", "128x128"),  # K % 8 == 4: rows not 16 bytes
    ((2048, 4104, 204), BF16, True, "simt", "128x128"),  # N % 8 == 4
    ((2048, 4104, 129), BF16, True, "simt", "128x128"),  # odd N
    ((2048, 3072, 3072), BF16, False, "simt", "128x128"),  # an operand off 16 bytes
    ((65, 3072, 3072), BF16, True, "wgmma", "128x128"),  # just above the small/large switch
    ((64, 3072, 3072), BF16, True, "wgmma", "64x128"),  # at it
    ((4, 3072, 3072), BF16, True, "wgmma", "64x128"),  # a decode tick
    ((65, 3072, 3072), FP32, True, "tf32x3", "128x128"),
    ((64, 3072, 3072), FP32, True, "stream", "64x128"),  # fp32 at M <= 64: B streamed by TMA
    ((4, 3072, 3072), FP32, True, "stream", "4x128"),  # the fp32 decode tick
    ((64, 4100, 201), FP32, False, "simt", "16x128"),  # TMA cannot read it
    ((1, 3072, 3072), FP32, True, "stream", "4x128"),  # M padded to the row configs
    ((5, 3072, 3072), FP32, True, "stream", "8x128"),
    ((16, 1024, 4096), FP32, True, "stream", "16x128"),
    ((33, 512, 2048), FP32, True, "stream", "64x128"),
    ((4, 3072, 3072), FP32, False, "simt", "16x128"),  # an operand off 16 bytes
    ((4, 4098, 3072), FP32, True, "simt", "16x128"),  # K % 4 != 0: A's rows not 16 bytes
    ((4, 512, 51865), FP32, True, "simt", "16x128"),  # Whisper's fp32 head: N % 4 != 0
    ((1, 200, 129), BF16, True, "simt", "16x128"),  # M = 1, odd N
    ((33, 65, 17), BF16, True, "simt", "16x128"),  # tests/test_kernels.py::MM_CASES
    ((100, 300, 50), BF16, True, "simt", "128x128"),
])
def test_matmul_plan_route(mkn, dtype, aligned, route, tile):
    m, k, n = mkn
    p = launcher.plan(m, n, k, dtype, aligned, H100_SMS)
    assert (p.route, p.tile) == (route, tile)


@pytest.mark.parametrize("m, k, n, splits", [
    (2048, 2560, 80, 10),  # Zamba2 dt_proj: 16 tiles, K cut to the 256 floor
    (2048, 2560, 128, 10),  # Zamba2 bc_proj
    (2048, 3072, 256, 8),  # StarCoder2 k/v: 32 tiles; 9 chunks of 342 round to 8 of 384
    (2048, 3072, 3072, 1),  # 384 tiles fill 132 SMs twice over
    (4, 3072, 3072, 10),  # decode: 24 tiles of 64 x 128
    (4, 3072, 49152, 1),  # decode head: 384 tiles
    (2048, 300, 256, 1),  # K below two chunks of 256
])
def test_matmul_plan_splits(m, k, n, splits):
    p = launcher.plan(m, n, k, BF16, True, H100_SMS)
    assert p.splits == splits
    bk = launcher.TILES[p.route, p.tile][2]
    kchunk = launcher._kchunk(k, splits, bk)
    # every chunk is whole K steps, at least 256 deep unless K is not cut,
    # and none is empty
    assert kchunk % bk == 0 and (splits == 1 or kchunk >= launcher.MIN_KCHUNK)
    assert (splits - 1) * kchunk < k <= splits * kchunk


class _FakeLib:
    """Stands in for the CUDA library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def repro_matmul(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("m, k, n", [(2048, 3072, 256), (2048, 3072, 3072), (100, 300, 50)])
def test_matmul_launch_is_one_library_call(m, k, n, monkeypatch):
    """A launch is one call into the library, with the plan's route, tile
    and splits, and a workspace exactly when K is split."""
    fake = _FakeLib()
    monkeypatch.setattr(launcher, "_lib", lambda: fake)
    a, b = torch.zeros((m, k), dtype=BF16), torch.zeros((k, n), dtype=BF16)
    out = torch.empty((m, n), dtype=BF16)
    p = launcher.plan(m, n, k, BF16, True, H100_SMS)
    launcher.launch(a, b, out, p, 0)
    assert len(fake.calls) == 1
    (pa, pb, pc, ws, cm, cn, ck, splits, route, tile, din, dout, dev, stream) = fake.calls[0]
    assert (pa, pb, pc) == (a.data_ptr(), b.data_ptr(), out.data_ptr())
    assert (cm, cn, ck, splits) == (m, n, k, p.splits)
    assert route == launcher.ROUTES[p.route] and tile == launcher.TILES[p.route, p.tile][3]
    assert (din, dout, dev, stream) == (1, 1, 0, 0)
    assert (ws is None) == (p.splits == 1)


def test_matmul_plan_is_cached():
    """The plan of a shape is computed once per card and shape."""
    launcher.plan(4, 3072, 3072, BF16, True, H100_SMS)
    hits = launcher.plan.cache_info().hits
    for _ in range(3):
        launcher.plan(4, 3072, 3072, BF16, True, H100_SMS)
    assert launcher.plan.cache_info().hits == hits + 3


def test_matmul_cpu_counts_no_launch():
    """On the CPU the wrapper takes the plain version and counts no launch."""
    before, by_route = matmul.launches, dict(matmul.launches_by_route)
    matmul(torch.ones((4, 8), dtype=BF16), torch.ones((8, 16), dtype=BF16))
    assert matmul.launches == before and matmul.launches_by_route == by_route


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


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
    m, k, n = mkn
    _check_on_card(at, bt, _route(name, m, k, n))


def _route(name, m, k, n):
    """The route the plan names for an aligned (M, K) @ (K, N) in ``name``."""
    if name == "bfloat16":
        return "wgmma" if k % 8 == 0 and n % 8 == 0 else "simt"
    if m > launcher.SMALL_M:
        return "tf32x3"
    return "stream" if k % 4 == 0 and n % 4 == 0 else "simt"


def _check_on_card(a, b, route, out_dtype=None):
    """One call of the kernel on the card: one launch, on ``route``, within
    the tolerance of its plain version on the same inputs."""
    before, by_route = matmul.launches, dict(matmul.launches_by_route)
    out = matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    assert matmul.launches_by_route[route] == by_route[route] + 1, matmul.launches_by_route
    assert out.dtype == (out_dtype or a.dtype) and out.shape == (a.shape[0], b.shape[1])
    ref = matmul_ref(a, b, out_dtype=out_dtype).float()
    # tests/test_kernels.py::_tol, by the coarser of the two dtypes
    tol = 2e-2 if torch.bfloat16 in (a.dtype, out.dtype) else 2e-4
    if a.shape[1] >= 1024:  # large K: hold the error to the output's scale
        err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        assert err <= tol, err
    else:
        torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2048, 4])
@pytest.mark.parametrize("kn", LM_SHAPES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_matmul_model_shapes_on_card(kn, m, name, cuda_device):
    """Every product shape of StarCoder2-3B and Zamba2-2.7B, at prefill
    (4 x 512 rows) and at a 4-slot decode tick."""
    k, n = kn
    _, _, at, bt = _inputs((m, k, n), name, seed=k + n)
    _check_on_card(at.to(cuda_device), bt.to(cuda_device) * k ** -0.5, _route(name, m, k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2048 + 65, 130, 4])
@pytest.mark.parametrize("kn", [(64, 64), (128, 128), (192, 192), (4104, 200), (200, 72),
                                (64, 8)])
def test_matmul_swizzle_atoms_on_card(kn, m, cuda_device):
    """K and N of 1, 2 and 3 128-byte swizzle atoms (64 bf16 values), ragged
    tails of M, K and N, and N below one atom, on the wgmma route."""
    k, n = kn
    _, _, at, bt = _inputs((m, k, n), "bfloat16", seed=m + k + n)
    _check_on_card(at.to(cuda_device), bt.to(cuda_device), "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(2048, 3072, 256), (4, 3072, 3072), (300, 512, 80)])
@pytest.mark.parametrize("pair", [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
                                  ("float32", "float32"), ("float32", "bfloat16")])
def test_matmul_dtype_pairs_on_card(mkn, pair, cuda_device):
    """All four (operand, output) dtype pairs, on the route of the operands."""
    name, out_name = pair
    _, _, at, bt = _inputs(mkn, name)
    _check_on_card(at.to(cuda_device), bt.to(cuda_device), _route(name, *mkn),
                   out_dtype=DTYPES[out_name])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("mkn", [(2048, 512, 256), (4, 512, 256)])
def test_matmul_misaligned_operand_takes_simt_on_card(mkn, which, cuda_device):
    """A contiguous operand whose storage starts 2 bytes off a 16-byte
    boundary cannot be read by TMA: it takes the simt route and still
    matches."""
    m, k, n = mkn
    _, _, at, bt = _inputs(mkn, "bfloat16")
    at, bt = at.to(cuda_device), bt.to(cuda_device)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    if which == "a":
        at = shifted(at)
    else:
        bt = shifted(bt)
    assert (at.data_ptr() | bt.data_ptr()) % 16 != 0 and at.is_contiguous()
    _check_on_card(at, bt, "simt")
