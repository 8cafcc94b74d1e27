"""The fp32 tf32x3 routes of the port's matmul and conv: the split of fp32
into two TF32 halves and the three-product arithmetic
(``repro_torch.kernels.tf32``, plain torch) against the JAX package's
Pallas kernels (interpret mode, as tests/test_kernels.py runs them) and
oracles on the same numpy inputs; why one TF32 product is not enough; the
tf32x3 operands' layout. The CUDA kernels themselves are held to their
plain versions by the ``cuda``-marked cases, which run only on a machine
with a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.conv2d import conv2d as conv_launcher  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402
from repro_torch.kernels.matmul import matmul as mm_launcher  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402
from repro_torch.kernels.tf32 import (conv2d_tf32x3, matmul_tf32x3, round_tf32,  # noqa: E402
                                      split_tf32)

MM_CASES = [(256, 512, 256), (100, 300, 50), (64, 64, 64), (128, 1, 128),
            (33, 65, 17)]  # tests/test_kernels.py::MM_CASES
CONV_CASES = [(1, 16, 16, 16, 32, 3), (2, 3, 20, 24, 64, 5), (1, 8, 10, 10, 16, 1),
              (1, 64, 7, 9, 8, 7)]  # tests/test_kernels.py::CONV_CASES
FP32 = torch.float32
MM_TOL = dict(atol=1e-3, rtol=1e-4)  # tests/test_kernels.py::test_matmul_matches_ref, fp32
CONV_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_kernels.py::_tol, fp32
FP32_GATE = 2e-4  # normalised error max|d| / max|ref| of an fp32 kernel row
FP32_ACCURATE = 1e-5  # the same against float64 at the LMs' and VGG's depths of K
H100_SMS = 132


@pytest.fixture
def jnp():
    """JAX is imported here, not at the top: the machine with the card has
    none, and the ``cuda`` cases below must still run there."""
    pytest.importorskip("jax")
    import jax.numpy
    return jax.numpy


def _normalised(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) & 0x1FFF


def _mm_inputs(m, k, n, seed=0, scale_b=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    if scale_b:
        b = (b * k ** -0.5).astype(np.float32)
    return a, b, torch.from_numpy(a), torch.from_numpy(b)


def _conv_inputs(case, seed=0):
    n, c, h, w, k, r = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    wt = (rng.standard_normal((k, c, r, r)) * 0.1).astype(np.float32)
    return x, wt, torch.from_numpy(x), torch.from_numpy(wt)


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_split_halves_are_tf32_and_exact_to_2_pow_22(seed):
    """hi and lo have their low 13 mantissa bits zero, and hi + lo is x to
    within 2^-22 |x|, on seeded normal x of both signs over 2^-100..2^100
    (where lo is normal too)."""
    rng = np.random.default_rng(seed)
    mag = np.exp2(rng.uniform(-100, 100, 4096))
    x = torch.from_numpy((mag * rng.choice([-1.0, 1.0], 4096)).astype(np.float32))
    hi, lo = split_tf32(x)
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all()), float((err / x.abs()).max())
    # hi alone is x to half a TF32 ulp: 2^-11 |x|
    assert bool(((x.double() - hi.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())


def test_split_zeros_and_subnormals():
    """Zeros split into zeros; subnormals into TF32 halves within half the
    subnormal TF32 spacing (2^-137)."""
    tiny = torch.finfo(FP32).tiny  # 2^-126, the smallest normal
    x = torch.tensor([0.0, -0.0, tiny / 2, -tiny / 3, tiny * (1 - 2 ** -20), 2.0 ** -149,
                      -(2.0 ** -140), tiny / 1000], dtype=FP32)
    assert bool(((x != 0) & (x.abs() < tiny)).sum() == 6)
    hi, lo = split_tf32(x)
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    assert torch.equal(hi[:2], x[:2]) and not lo[:2].any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -137).all()), err.max().item()


def test_round_tf32_ties_away_and_specials():
    """Round to nearest, ties away from zero (cvt.rna), in both signs;
    infinities and NaN pass."""
    one = 1.0
    cases = {one + 2 ** -11: one + 2 ** -10,  # a tie: away from zero
             -(one + 2 ** -11): -(one + 2 ** -10),
             one + 2 ** -11 - 2 ** -23: one,  # just below the tie
             one + 3 * 2 ** -11: one + 2 ** -9,  # a tie: away, not to even
             2.0 ** 127 * (2 - 2 ** -23): float("inf")}  # past the largest TF32
    x = torch.tensor(list(cases), dtype=FP32)
    assert torch.equal(round_tf32(x), torch.tensor(list(cases.values()), dtype=FP32))
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = round_tf32(special)
    assert torch.equal(out[:2], special[:2]) and torch.isnan(out[2])


# ---------------------------------------------------------------------------
# The three-product arithmetic against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mkn", MM_CASES)
def test_matmul_tf32x3_matches_jax(mkn, jnp):
    from repro.kernels.matmul.ops import matmul as jax_matmul
    a, b, at, bt = _mm_inputs(*mkn)
    out = matmul_tf32x3(at, bt)
    assert out.dtype == FP32 and out.shape == (mkn[0], mkn[2])
    pallas = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b), bm=64, bn=64, bk=128))
    np.testing.assert_allclose(out.numpy(), pallas, **MM_TOL)


@pytest.mark.parametrize("k", [3072, 12288])
def test_matmul_tf32x3_large_k_matches_jax_ref(k, jnp):
    """StarCoder2-3B's d_model and d_ff as K, B scaled by K^-0.5 (as the
    model's weights): within the fp32 gate of JAX's oracle, normalised."""
    from repro.kernels.matmul.ref import matmul_ref as jax_matmul_ref
    a, b, at, bt = _mm_inputs(256, k, 256, seed=k, scale_b=True)
    ref = np.asarray(jax_matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    assert _normalised(matmul_tf32x3(at, bt).numpy(), ref) <= FP32_GATE


def test_one_tf32_product_misses_fp32_and_three_meet_it():
    """Why the route takes three products: at K = 3072 one TF32 product's
    normalised error against float64 exceeds fp32's 2e-4, three stay
    under 1e-5 (an fp32 product's order)."""
    a, b, at, bt = _mm_inputs(256, 3072, 256, seed=1, scale_b=True)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    three = _normalised(matmul_tf32x3(at, bt).numpy(), ref)
    one = _normalised(matmul_tf32x3(at, bt, products=1).numpy(), ref)
    assert three <= 1e-5, three
    assert one > FP32_GATE, one


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_tf32x3_matches_jax(case, jnp):
    from repro.kernels.conv2d.ops import conv2d as jax_conv2d
    x, w, xt, wt = _conv_inputs(case)
    out = conv2d_tf32x3(xt, wt)
    assert out.dtype == FP32 and out.shape == (case[0], case[4], case[2], case[3])
    pallas = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), bk=16))
    np.testing.assert_allclose(out.numpy(), pallas, **CONV_TOL)


def test_conv2d_tf32x3_vgg_width_matches_jax_oracle(jnp):
    """A VGG-16 width (C = K = 64 at 28 x 28) against the lax oracle."""
    from repro.kernels.conv2d.ref import conv2d_ref as jax_conv2d_ref
    case = (1, 64, 28, 28, 64, 3)
    x, w, xt, wt = _conv_inputs(case, seed=3)
    ref = np.asarray(jax_conv2d_ref(jnp.asarray(x), jnp.asarray(w)))
    out = conv2d_tf32x3(xt, wt).numpy()
    np.testing.assert_allclose(out, ref, **CONV_TOL)
    assert _normalised(out, ref) <= 1e-5


def test_conv2d_one_tf32_product_misses_fp32():
    """The conv's reduction at VGG-16's deepest layers (C = 512, 3 x 3: 4608
    terms) shows the same: one TF32 product misses 2e-4, three meet 1e-5."""
    x, w, xt, wt = _conv_inputs((1, 512, 6, 6, 16, 3), seed=4)
    ref = torch.nn.functional.conv2d(xt.double(), wt.double(), padding=1).numpy()
    assert _normalised(conv2d_tf32x3(xt, wt).numpy(), ref) <= 1e-5
    assert _normalised(conv2d_tf32x3(xt, wt, products=1).numpy(), ref) > FP32_GATE


# ---------------------------------------------------------------------------
# The tf32x3 operands and the launches, on the CPU
# ---------------------------------------------------------------------------


def _tf32x3_operands(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """The conv's tf32x3 operands before the split, in plain torch: x as
    NHWC, w as a (K, R*S*C) matrix whose column t*C + c holds tap t = r*S
    + s of input channel c. ``conv_launcher.split`` writes their TF32
    halves on the card."""
    k, c, r, s = w.shape
    return (x.permute(0, 2, 3, 1).contiguous(),
            w.permute(0, 2, 3, 1).reshape(k, r * s * c).contiguous())


def test_tf32x3_operands_layout():
    """x goes to NHWC; w's row k, column t*C + c, t = r*S + s, holds w[k, c, r, s]."""
    x = torch.arange(2 * 32 * 3 * 5, dtype=FP32).reshape(2, 32, 3, 5)
    w = torch.arange(8 * 32 * 3 * 2, dtype=FP32).reshape(8, 32, 3, 2)
    xh, wm = _tf32x3_operands(x, w)
    assert xh.is_contiguous() and torch.equal(xh[1, 2, 4], x[1, :, 2, 4])
    assert wm.shape == (8, 3 * 2 * 32) and wm.is_contiguous()
    for r, s, c in [(0, 0, 0), (2, 1, 31), (1, 0, 5)]:
        assert torch.equal(wm[:, (r * 2 + s) * 32 + c], w[:, c, r, s])


@pytest.mark.parametrize("k, kp", [(1, 32), (32, 32), (33, 64), (3072, 3072), (4100, 4128)])
def test_matmul_padded_k(k, kp):
    assert mm_launcher.padded_k(k) == kp


class _FakeLib:
    """Stands in for the CUDA libraries: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("repro_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("m, k, n", [(2048, 3072, 256), (2048, 3072, 3072), (100, 300, 50),
                                     (65, 77, 201)])
@pytest.mark.parametrize("out_name", ["float32", "bfloat16"])
def test_matmul_tf32x3_launch_is_one_library_call(m, k, n, out_name, monkeypatch):
    """An fp32 product with M > 64 is one call of the tf32x3 entry point,
    with four 16-byte aligned, disjoint parts of one scratch buffer for the
    split operands and a workspace exactly when K is split."""
    fake = _FakeLib()
    monkeypatch.setattr(mm_launcher, "_lib", lambda: fake)
    a, b = torch.zeros((m, k)), torch.zeros((k, n))
    out = torch.empty((m, n), dtype=getattr(torch, out_name))
    p = mm_launcher.plan(m, n, k, FP32, True, H100_SMS)
    assert p.route == "tf32x3"
    mm_launcher.launch(a, b, out, p, 0)
    assert [name for name, _ in fake.calls] == ["repro_matmul_tf32x3"]
    (pa, pb, pc, ahi, alo, bhi, blo, ws, cm, cn, ck, splits, dout, dev, stream) = fake.calls[0][1]
    assert (pa, pb, pc) == (a.data_ptr(), b.data_ptr(), out.data_ptr())
    assert (cm, cn, ck, splits, dev, stream) == (m, n, k, p.splits, 0, 0)
    assert dout == mm_launcher.DTYPE_CODES[out.dtype]
    parts = [ahi, alo, bhi, blo]
    kp = mm_launcher.padded_k(k)
    sizes = [m * kp * 4, m * kp * 4, n * kp * 4, n * kp * 4]
    assert all(x % 16 == 0 for x in parts)
    assert all(x + size <= y for x, size, y in zip(parts, sizes, parts[1:]))
    assert (ws is None) == (p.splits == 1) and (ws is None or ws >= blo + sizes[3])


@pytest.mark.parametrize("shape", [(8, 512, 14, 14, 512, 3), (2, 64, 9, 11, 64, 3),
                                   (1, 32, 7, 9, 12, 1), (2, 96, 5, 6, 200, 4)])
def test_conv2d_tf32x3_launch_is_one_library_call(shape, monkeypatch):
    """An fp32 conv with C % 32 == 0 is one call of the tf32x3 entry point,
    with the plan's box, splits and channels a block, four aligned parts
    for the split operands and a workspace exactly when the steps are split."""
    import types
    fake = _FakeLib()
    monkeypatch.setattr(conv_launcher, "_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    n, c, h, w, k, r = shape
    x, wt = torch.zeros((n, c, h, w)), torch.zeros((k, c, r, r))
    out = torch.empty((n, k, h, w))
    p = conv_launcher.plan(n, c, h, w, k, r, r, FP32, H100_SMS)
    assert p.route == "tf32x3" and p.blocks == 1
    conv_launcher.launch(x, wt, out, p)
    assert [name for name, _ in fake.calls] == ["repro_conv2d_tf32x3"]
    (px, pw, py, xhi, xlo, whi, wlo, ws, *dims, bw, bh, splits, tile_n, dev,
     stream) = fake.calls[0][1]
    assert (px, pw, py) == (x.data_ptr(), wt.data_ptr(), out.data_ptr())
    assert dims == [n, c, h, w, k, r, r] and (dev, stream) == (0, 0)
    assert (bw, bh, splits, tile_n) == (*p.box, p.splits, p.tile_n)
    parts = [xhi, xlo, whi, wlo]
    sizes = [x.numel() * 4] * 2 + [wt.numel() * 4] * 2
    assert all(v % 16 == 0 for v in parts)
    assert all(v + size <= u for v, size, u in zip(parts, sizes, parts[1:]))
    assert (ws is None) == (p.splits == 1)


@pytest.mark.parametrize("shape, splits", [
    ((8, 512, 14, 14, 512, 3), 2),  # 64 tiles on 132 SMs: 144 steps of 32 channels in 2
    ((8, 512, 28, 28, 512, 3), 1),  # 224 tiles fill the card
    ((1, 512, 14, 14, 512, 3), 16),  # 8 tiles: 16 splits of 9 steps, one wave
    ((2, 64, 9, 11, 64, 3), 4),  # 18 steps: 4 splits of 5
])
def test_conv2d_tf32x3_plan_splits(shape, splits):
    n, c, h, w, k, r = shape
    p = conv_launcher.plan(n, c, h, w, k, r, r, FP32, H100_SMS)
    steps = r * r * c // conv_launcher.TF32_BK
    chunk = conv_launcher.kchunk(steps, p.splits)
    assert p.route == "tf32x3" and p.blocks == 1 and p.splits == splits
    assert p.splits == 1 or chunk >= conv_launcher.MIN_SPLIT_STEPS
    assert (p.splits - 1) * chunk < steps <= p.splits * chunk


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on_card_matmul(a, b, out_dtype=None):
    """One matmul call on the card: one launch, on tf32x3, within the fp32
    gate of its plain version on the same inputs (normalised), or bf16's
    when the output is bf16."""
    before, by = matmul.launches, dict(matmul.launches_by_route)
    out = matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    assert matmul.launches_by_route["tf32x3"] == by["tf32x3"] + 1, matmul.launches_by_route
    ref = matmul_ref(a, b, out_dtype=out_dtype).float()
    gate = FP32_GATE if out.dtype == FP32 else 2e-2
    assert _normalised(out.float().cpu(), ref.cpu()) <= gate
    if out.dtype == FP32 and a.shape[1] < 1024:
        torch.testing.assert_close(out, ref, atol=2e-4, rtol=2e-4)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(256, 512, 256), (100, 300, 50), (128, 1, 128), (65, 77, 201),
                                 (300, 4100, 129), (2048, 3072, 256), (2048, 2560, 80),
                                 (130, 64, 8), (2048 + 65, 200, 200)])
def test_matmul_tf32x3_matches_plain_on_card(mkn, cuda_device):
    """Ragged M, K and N, K below one step, K % 4 != 0 (rows off 16
    bytes), odd N, N below one tile, split K."""
    m, k, n = mkn
    _, _, at, bt = _mm_inputs(m, k, n, seed=m + k + n, scale_b=True)
    _on_card_matmul(at.to(cuda_device), bt.to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["a", "b"])
def test_matmul_tf32x3_misaligned_operand_on_card(which, cuda_device):
    """An operand 4 bytes off a 16-byte boundary: the split pass reads it, so
    the product stays on tf32x3."""
    _, _, at, bt = _mm_inputs(256, 300, 72, scale_b=True)
    at, bt = at.to(cuda_device), bt.to(cuda_device)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    at, bt = (shifted(at), bt) if which == "a" else (at, shifted(bt))
    assert (at.data_ptr() | bt.data_ptr()) % 16 != 0
    _on_card_matmul(at, bt)


@pytest.mark.cuda
@pytest.mark.parametrize("out_name", ["float32", "bfloat16"])
def test_matmul_tf32x3_out_dtypes_on_card(out_name, cuda_device):
    _, _, at, bt = _mm_inputs(2048, 512, 256, scale_b=True)
    _on_card_matmul(at.to(cuda_device), bt.to(cuda_device), out_dtype=getattr(torch, out_name))


@pytest.mark.cuda
def test_matmul_tf32x3_is_exact_on_small_integers_on_card(cuda_device):
    """Small integers are TF32 values (lo = 0) and their sums are exact in
    fp32: the kernel equals the plain version bit for bit, which pins the
    descriptors' k8 slices and the tiles' rows and columns."""
    g = torch.Generator().manual_seed(5)
    a = torch.randint(-8, 9, (200, 136), generator=g).float().to(cuda_device)
    b = torch.randint(-8, 9, (136, 264), generator=g).float().to(cuda_device)
    assert torch.equal(_on_card_matmul(a, b), matmul_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(2048, 3072, 256), (100, 300, 50), (65, 77, 201)])
def test_matmul_split_pass_on_card(mkn, cuda_device):
    """The split pass gives split_tf32 of A and of B's transpose, K
    zero-padded to whole steps, bit for bit."""
    m, k, n = mkn
    _, _, at, bt = _mm_inputs(m, k, n, scale_b=True)
    at, bt = at.to(cuda_device), bt.to(cuda_device)
    got = mm_launcher.split(at, bt)
    torch.cuda.synchronize()
    kp = mm_launcher.padded_k(k)
    pad = torch.nn.functional.pad
    want = [*split_tf32(pad(at, (0, kp - k))), *split_tf32(pad(bt.T.contiguous(), (0, kp - k)))]
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.view(torch.int32), w_.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3072, 12288])
def test_matmul_tf32x3_is_fp32_accurate_on_card(k, cuda_device):
    """StarCoder2-3B's prefill products over K = 3072 and 12288 (M = 4 x
    512, N = 3072: one split, the whole of K in one chain; B scaled by
    K^-0.5) within 1e-5 of a float64 product, normalised: an fp32
    product's order. The 2e-4 gate would pass a kernel that dropped one of
    the three products, or let the tensor cores' truncating accumulator
    run over all of K (9.4e-5 at K = 12288, PERF.md); this does not."""
    _, _, at, bt = _mm_inputs(2048, k, 3072, seed=k, scale_b=True)
    at, bt = at.to(cuda_device), bt.to(cuda_device)
    assert mm_launcher.plan_for(at, bt).splits == 1
    out = _on_card_matmul(at, bt)
    assert _normalised(out.cpu(), (at.double() @ bt.double()).cpu()) <= FP32_ACCURATE


TF32_CONV_CASES = [(2, 64, 9, 11, 64, 3), (1, 128, 7, 13, 200, 3), (2, 32, 5, 7, 8, 1),
                   (1, 96, 12, 10, 72, 4), (1, 128, 6, 9, 136, 7), (1, 64, 30, 33, 12, 3),
                   (2, 128, 17, 19, 64, 3), (8, 512, 14, 14, 512, 3)]


def _on_card_conv(x, w, plan=None):
    """One conv on the card: one launch on tf32x3 (or of ``plan``), within
    the fp32 tolerance of the plain version on the same inputs."""
    if plan is None:
        before, by = conv2d.launches, dict(conv2d.launches_by_route)
        out = conv2d(x, w)
        torch.cuda.synchronize()
        assert conv2d.launches == before + 1
        assert conv2d.launches_by_route["tf32x3"] == by["tf32x3"] + 1, conv2d.launches_by_route
    else:
        out = torch.empty((x.shape[0], w.shape[0], *x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        conv_launcher.launch(x, w, out, plan)
        torch.cuda.synchronize()
    torch.testing.assert_close(out, conv2d_ref(x, w), **CONV_TOL)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", TF32_CONV_CASES)
def test_conv2d_tf32x3_matches_plain_on_card(case, cuda_device):
    """C of one to sixteen 32-channel steps, C = 96 (not a bf16 route
    shape), K of 8, 12 (K % 8 != 0), 64, 72, 136, 200; R of 1, 3, 4, 7;
    VGG-16's 14 x 14 layer at batch 8 (split steps)."""
    _, _, xt, wt = _conv_inputs(case)
    _on_card_conv(xt.to(cuda_device), wt.to(cuda_device))


@pytest.mark.cuda
def test_conv2d_tf32x3_is_fp32_accurate_on_card(cuda_device):
    """VGG-16's 512-channel 28 x 28 layer at batch 8 (one split: the whole
    R*S*C = 4608 reduction in one chain) within 1e-5 of a float64 conv,
    normalised, as the products above."""
    _, _, xt, wt = _conv_inputs((8, 512, 28, 28, 512, 3))
    xt, wt = xt.to(cuda_device), wt.to(cuda_device)
    assert conv_launcher.plan_for(xt, wt).splits == 1
    out = _on_card_conv(xt, wt)
    ref = torch.nn.functional.conv2d(xt.double(), wt.double(), padding=1)
    assert _normalised(out.cpu(), ref.cpu()) <= FP32_ACCURATE


@pytest.mark.cuda
@pytest.mark.parametrize("box", conv_launcher.BOXES)
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("tile_n", conv_launcher.TILES_N)
def test_conv2d_tf32x3_every_box_on_card(box, splits, tile_n, cuda_device):
    _, _, xt, wt = _conv_inputs((2, 64, 10, 13, 72, 4), seed=1)
    _on_card_conv(xt.to(cuda_device), wt.to(cuda_device),
                  plan=conv_launcher.Plan("tf32x3", box, splits, 1, tile_n))


@pytest.mark.cuda
@pytest.mark.parametrize("c, tap", [(32, (1, 1)), (32, (0, 0)), (64, (2, 2)), (64, (0, 2)),
                                    (96, (2, 0))])
def test_conv2d_tf32x3_probe_on_card(c, tap, cuda_device):
    """Exact: a 3x3 weight that is the identity over channels at one tap
    shifts the image by that tap, zeros where the box runs off it. Small
    integers are TF32 values, so the kernel equals the plain version bit
    for bit; each channel of up to three 32-channel steps checks B's rows."""
    n, h, w = 2, 9, 11
    idx = torch.stack(torch.meshgrid(*(torch.arange(d) for d in (n, c, h, w)), indexing="ij"))
    x = ((idx[0] * 7 + idx[1] * 3 + idx[2] * 5 + idx[3]) % 17 - 8).float().to(cuda_device)
    wt = torch.zeros((c, c, 3, 3))
    wt[torch.arange(c), torch.arange(c), tap[0], tap[1]] = 1
    out = _on_card_conv(x, wt.to(cuda_device))
    assert torch.equal(out, conv2d_ref(x, wt.to(cuda_device)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", TF32_CONV_CASES[:3] + TF32_CONV_CASES[-1:])
def test_conv2d_split_on_card(case, cuda_device):
    """The route's re-layout gives split_tf32 of _tf32x3_operands bit for bit."""
    _, _, xt, wt = _conv_inputs(case)
    xt, wt = xt.to(cuda_device), wt.to(cuda_device)
    got = conv_launcher.split(xt, wt)
    torch.cuda.synchronize()
    xh, wm = _tf32x3_operands(xt, wt)
    for g_, w_ in zip(got, [*split_tf32(xh), *split_tf32(wm)]):
        assert torch.equal(g_.view(torch.int32), w_.view(torch.int32))
