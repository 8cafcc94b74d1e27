"""The fp32 routes of the matmul at M <= 64 (``stream``: B streamed by TMA
into fp32 FMA on the CUDA cores) and of flash attention (``tf32x3``: QK^T
and PV as three TF32 products on the tensor cores): the stream plan of
every product of the LMs' fp32 decode tick, their launches as one library
call, and the split flash arithmetic
(``repro_torch.kernels.tf32.flash_attention_tf32x3``, plain torch) against
the JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py
runs it), the port's ``attention_ref`` and float64, on the same numpy
inputs. The CUDA kernels themselves are held to their plain versions and
to float64 by the ``cuda``-marked cases, which run only on a machine with
a card."""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fl_launcher  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.matmul import matmul as mm_launcher  # noqa: E402
from repro_torch.kernels.matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402
from repro_torch.kernels.tf32 import FLASH_BK, FLASH_BQ, flash_attention_tf32x3  # noqa: E402

FP32, BF16 = torch.float32, torch.bfloat16
H100_SMS = 132
FP32_GATE = 2e-4  # normalised error max|d| / max|ref| of an fp32 row (tests/test_kernels.py::_tol)
FP32_ACCURATE = 1e-5  # the same against float64: what an fp32 product or attention reaches
# (b, s, s_k, h, kv, hd, causal, window) at the models' head dims, 128
# (StarCoder2: GQA 12 to 1), 80 (Zamba2) and 64 (Whisper): S not a multiple
# of the 64-row block, S < Sk, a window, no mask.
FLASH_CASES = [(1, 200, 200, 4, 2, 128, True, None), (2, 130, 130, 4, 4, 80, True, None),
               (1, 150, 150, 2, 2, 80, True, 64), (1, 60, 150, 3, 1, 128, True, 32),
               (1, 90, 170, 2, 2, 80, True, None), (1, 77, 77, 2, 1, 64, False, None),
               (1, 130, 130, 2, 1, 64, True, 40), (2, 70, 70, 12, 1, 128, True, None)]


@pytest.fixture
def jax():
    """JAX is imported here, not at the top: the machine with the card has
    none, and the ``cuda`` cases below must still run there."""
    return pytest.importorskip("jax")


def _f64(x) -> torch.Tensor:
    return x.double().cpu() if torch.is_tensor(x) else torch.from_numpy(np.array(x, np.float64))


def _normalised(out, ref) -> float:
    out, ref = _f64(out), _f64(ref)
    return float((out - ref).abs().max() / ref.abs().max())


def _attn_inputs(b, s, s_k, h, kv, hd, seed=0):
    """q, k, v as numpy float32 and as tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s_k, kv, hd), (b, s_k, kv, hd))]
    return arrs, [torch.from_numpy(a) for a in arrs]


def attention_f64(q, k, v, *, causal, window):
    """The attention of attention_ref in float64; a row with no key gives 0."""
    b, s, h, hd = q.shape
    _, s_k, kv, _ = k.shape
    qd = q.double().transpose(1, 2)
    kd, vd = (t.double().transpose(1, 2).repeat_interleave(h // kv, dim=1) for t in (k, v))
    scores = qd @ kd.transpose(-1, -2) / math.sqrt(hd)
    qi = torch.arange(s, device=q.device)[:, None] + (s_k - s)
    kj = torch.arange(s_k, device=q.device)[None, :]
    ok = torch.ones((s, s_k), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= kj > qi - window
    probs = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1).nan_to_num(0.0)
    return (probs @ vd).transpose(1, 2)


def tick_products(arch: str) -> list:
    """(K, N) of every distinct product of one decode tick of ``arch``."""
    cfg = get_config(arch)
    hd, d = cfg.head_dim, cfg.d_model
    shapes = {(d, cfg.n_heads * hd), (d, cfg.n_kv * hd), (cfg.n_heads * hd, d), (d, cfg.d_ff),
              (cfg.d_ff, d), (d, cfg.vocab)}
    if cfg.family == "hybrid":
        d_in = cfg.ssm.expansion * d
        shapes |= {(d, 2 * d_in), (d, 2 * cfg.ssm.state_dim), (d, d_in // cfg.ssm.head_dim),
                   (d_in, d)}
    return sorted(shapes)


# ---------------------------------------------------------------------------
# The matmul's stream route: plan and launch (no card needed; the plan's
# routes are cases of tests/test_torch_matmul.py::test_matmul_plan_route)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["starcoder2-3b", "zamba2-2.7b"])
def test_matmul_stream_takes_every_tick_product(arch):
    """Every product of both LMs' fp32 decode tick (M = 4) is on the stream
    route; K is cut only where the column tiles give fewer than two blocks
    an SM, into chunks of whole 32-deep stages no shallower than 256."""
    for k, n in tick_products(arch):
        p = mm_launcher.plan(4, n, k, FP32, True, H100_SMS)
        assert (p.route, p.tile) == ("stream", "4x128"), (k, n)
        tiles = -(-n // 128)
        if tiles >= 2 * H100_SMS or k < 2 * mm_launcher.MIN_KCHUNK:
            assert p.splits == 1, (k, n)
        else:
            chunk = mm_launcher._kchunk(k, p.splits, 32)
            assert p.splits > 1 and chunk >= mm_launcher.MIN_KCHUNK, (k, n)
            assert (p.splits - 1) * chunk < k <= p.splits * chunk


def test_matmul_stream_tile_constants_match_kernel():
    """The columns a block and the k rows a stage that the plan counts are
    the stream kernel's own, and its row counts are the kernel's configs."""
    src = (Path(mm_launcher.__file__).parent / "csrc" / "matmul.cu").read_text()
    st = src[src.index("namespace st {"):src.index("}  // namespace st")]
    assert int(re.search(r"constexpr int BN = (\d+);", st).group(1)) == 128
    assert int(re.search(r"constexpr int BK = (\d+);", st).group(1)) == 32
    cfgs = [int(r) for r in re.findall(r"using M\d+ = Cfg<(\d+), \d+>;", st)]
    assert tuple(cfgs) == mm_launcher.STREAM_ROWS
    for i, r in enumerate(mm_launcher.STREAM_ROWS):
        assert mm_launcher.TILES["stream", f"{r}x128"] == (r, 128, 32, i)
        assert f"case {i}: return launch<M{r}, TC>" in st


class _FakeMatmulLib:
    """Stands in for the CUDA library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def repro_matmul(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("m, k, n, out_dtype", [(4, 3072, 3072, FP32), (4, 3072, 49152, FP32),
                                                (33, 512, 2048, BF16), (1, 1024, 4096, FP32)])
def test_matmul_stream_launch_is_one_library_call(m, k, n, out_dtype, monkeypatch):
    """A launch is one call into the library, with route 3, the plan's tile
    code and splits, and a workspace exactly when K is split."""
    fake = _FakeMatmulLib()
    monkeypatch.setattr(mm_launcher, "_lib", lambda: fake)
    a, b = torch.zeros((m, k)), torch.zeros((k, n))
    out = torch.empty((m, n), dtype=out_dtype)
    p = mm_launcher.plan(m, n, k, FP32, True, H100_SMS)
    assert p.route == "stream"
    mm_launcher.launch(a, b, out, p, 0)
    assert len(fake.calls) == 1
    (pa, pb, pc, ws, cm, cn, ck, splits, route, tile, din, dout, dev, stream) = fake.calls[0]
    assert (pa, pb, pc) == (a.data_ptr(), b.data_ptr(), out.data_ptr())
    assert (cm, cn, ck, splits) == (m, n, k, p.splits)
    assert route == 3 == mm_launcher.ROUTES["stream"]
    assert tile == mm_launcher.TILES["stream", p.tile][3]
    assert (din, dout, dev, stream) == (0, mm_launcher.DTYPE_CODES[out_dtype], 0, 0)
    assert (ws is None) == (p.splits == 1)
    assert "stream" in matmul.launches_by_route


# ---------------------------------------------------------------------------
# Flash attention's tf32x3 route: plan and launch (no card needed; the
# plan's routes are cases of tests/test_torch_flash_attention.py::
# test_flash_plan_route)
# ---------------------------------------------------------------------------


def test_flash_tf32x3_tile_constants_match_kernel():
    """The query rows a block and keys a tile that the emulation walks are
    the kernel's own."""
    src = (Path(fl_launcher.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    tf = src[src.index("namespace tf {"):src.index("}  // namespace tf")]
    assert int(re.search(r"constexpr int BQ = (\d+);", tf).group(1)) == FLASH_BQ
    assert int(re.search(r"constexpr int BK = (\d+);", tf).group(1)) == FLASH_BK == fl_launcher.BK


@pytest.mark.parametrize("s_k, skp", [(1, 64), (64, 64), (65, 128), (512, 512), (1500, 1536)])
def test_flash_padded_keys(s_k, skp):
    assert fl_launcher.padded_keys(s_k) == skp


class _FakeFlashLib:
    """Stands in for the CUDA library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def repro_flash_attention_tf32x3(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("shape, s_k, causal, window", [
    ((4, 512, 24, 2, 128), 512, True, None),  # StarCoder2's prefill
    ((4, 512, 32, 32, 80), 512, True, None),  # Zamba2's
    ((4, 448, 8, 8, 64), 1500, False, None),  # Whisper's cross-attention
    ((1, 40, 4, 2, 32), 100, True, 16),
])
def test_flash_tf32x3_launch_is_one_library_call(shape, s_k, causal, window, monkeypatch):
    """A launch is one call into the library with q, k, v, the output, the
    four split parts in one scratch buffer (K_hi, K_lo of B*Sk*KV*hd values,
    V^T_hi, V^T_lo of B*KV*hd*Skp, each 256-byte aligned), the shape, the
    mask and 1 / sqrt(hd)."""
    fake = _FakeFlashLib()
    monkeypatch.setattr(fl_launcher, "_lib", lambda: fake)
    b, s, h, kv, hd = shape
    q, out = torch.zeros((b, s, h, hd)), torch.empty((b, s, h, hd))
    k, v = torch.zeros((b, s_k, kv, hd)), torch.zeros((b, s_k, kv, hd))
    route = fl_launcher.plan_for(q, k, v)
    assert route == "tf32x3"
    fl_launcher.launch(q, k, v, out, route, 0, causal=causal, window=window)
    assert len(fake.calls) == 1
    (pq, pk, pv, po, khi, klo, vhi, vlo, cb, cs, csk, ch, ckv, chd, ccausal, cwin, scale,
     dev, stream) = fake.calls[0]
    assert (pq, pk, pv, po) == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    k_bytes = b * s_k * kv * hd * 4
    v_bytes = b * kv * hd * fl_launcher.padded_keys(s_k) * 4
    assert klo - khi >= k_bytes and vhi - klo >= k_bytes and vlo - vhi >= v_bytes
    assert all(p % 256 == khi % 256 for p in (klo, vhi, vlo))
    assert (cb, cs, csk, ch, ckv, chd) == (b, s, s_k, h, kv, hd)
    assert (ccausal, cwin) == (int(causal), window or 0)
    assert scale == pytest.approx(1 / math.sqrt(hd))
    assert (dev, stream) == (0, 0)
    assert "tf32x3" in flash_attention.launches_by_route


# ---------------------------------------------------------------------------
# The split flash arithmetic, in plain torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_tf32x3_matches_ref_and_float64(case):
    """The emulated route against attention_ref at the fp32 gate and against
    float64 at 1e-5 normalised: causal, a window, S < Sk, GQA, no mask."""
    b, s, s_k, h, kv, hd, causal, win = case
    _, (qt, kt, vt) = _attn_inputs(b, s, s_k, h, kv, hd)
    out = flash_attention_tf32x3(qt, kt, vt, causal=causal, window=win)
    assert out.dtype == FP32 and out.shape == (b, s, h, hd)
    ref = attention_ref(qt, kt, vt, causal=causal, window=win)
    assert _normalised(out, ref) <= FP32_GATE
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=2e-4)
    assert _normalised(out, attention_f64(qt, kt, vt, causal=causal, window=win)) <= FP32_ACCURATE


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[1] == c[2]])
def test_flash_tf32x3_matches_jax(case, jax):
    """At S = Sk, the emulated route against the JAX Pallas kernel
    (interpret mode) and the JAX package's attention_ref, fp32."""
    from repro.kernels.flash_attention.ops import flash_attention as jax_flash
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    b, s, _, h, kv, hd, causal, win = case
    (q, k, v), (qt, kt, vt) = _attn_inputs(b, s, s, h, kv, hd)
    qj, kj, vj = (jax.numpy.asarray(a) for a in (q, k, v))
    out = flash_attention_tf32x3(qt, kt, vt, causal=causal, window=win).numpy()
    pallas = np.asarray(jax_flash(qj, kj, vj, causal=causal, window=win, bq=32, bk=32))
    assert _normalised(out, pallas) <= FP32_ACCURATE
    ref = np.asarray(jax_ref(qj, kj, vj, causal=causal, window=win))
    assert _normalised(out, ref) <= FP32_ACCURATE
    np.testing.assert_allclose(out, pallas, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("hd", [64, 80, 128])
def test_flash_one_tf32_product_misses_fp32_and_three_meet_it(hd):
    """One TF32 product a k8 (hi hi, the tensor cores' plain fp32 input)
    misses the fp32 gate against float64; the three products of the route
    meet 1e-5."""
    _, (qt, kt, vt) = _attn_inputs(2, 192, 192, 4, 2, hd, seed=hd)
    ref = attention_f64(qt, kt, vt, causal=True, window=None)
    one = flash_attention_tf32x3(qt, kt, vt, causal=True, products=1)
    three = flash_attention_tf32x3(qt, kt, vt, causal=True)
    assert _normalised(one, ref) > FP32_GATE
    assert _normalised(three, ref) <= FP32_ACCURATE


def test_flash_tf32x3_row_without_keys_is_zero():
    """Queries before the key timeline (S > Sk, causal) see no key: the
    emulated route gives exactly 0 there, as the kernel must."""
    _, (qt, kt, vt) = _attn_inputs(1, 150, 100, 2, 1, 80)
    out = flash_attention_tf32x3(qt, kt, vt, causal=True)
    assert (out[:, :50] == 0).all()
    ref = attention_ref(qt[:, 50:], kt, vt, causal=True)  # rows 50.. at positions 0..
    assert _normalised(out[:, 50:], ref) <= FP32_ACCURATE


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mm_on_card(m, k, n, route, seed=0, shift=None):
    """One counted matmul of seeded fp32 operands (B scaled by k^-1/2) on
    the card, on ``route``: within 2e-4 of the plain version and, when K
    is not tiny, 1e-5 of float64, both normalised."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    if shift is not None:  # the operand's storage 4 bytes past a 16-byte boundary
        t = a if shift == "a" else b
        buf = torch.empty(t.numel() + 1, device="cuda")
        view = buf[1:].view(t.shape)
        view.copy_(t)
        a, b = (view, b) if shift == "a" else (a, view)
    assert mm_launcher.plan_for(a, b).route == route
    before, by = matmul.launches, dict(matmul.launches_by_route)
    out = matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    assert matmul.launches_by_route[route] == by[route] + 1, matmul.launches_by_route
    assert _normalised(out, matmul_ref(a, b)) <= FP32_GATE
    assert _normalised(out, a.double() @ b.double()) <= FP32_ACCURATE
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-3b", "zamba2-2.7b"])
def test_matmul_stream_tick_products_on_card(arch, cuda_device):
    """Every product shape of the LM's fp32 decode tick (M = 4)."""
    for k, n in tick_products(arch):
        _mm_on_card(4, k, n, "stream", seed=k + n)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 16, 33, 64])
@pytest.mark.parametrize("k, n", [(3072, 3072), (516, 260), (100, 44), (2048, 1028)])
def test_matmul_stream_rows_and_ragged_edges_on_card(m, k, n, cuda_device):
    """M from 1 to 64 (every row config), K and N that end mid-stage and
    mid-tile, one K chunk (K = 100, 516) and several (K = 2048, 3072)."""
    p = mm_launcher.plan(m, n, k, FP32, True, mm_launcher.sm_count(0))
    assert (p.splits > 1) == (k >= 2 * mm_launcher.MIN_KCHUNK)
    _mm_on_card(m, k, n, "stream", seed=m + k + n)


@pytest.mark.cuda
def test_matmul_stream_bf16_output_on_card(cuda_device):
    """fp32 operands, a bf16 output: the stream route casts in the epilogue."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    a, b = torch.randn((4, 3072), generator=gen, device="cuda"), \
        torch.randn((3072, 2048), generator=gen, device="cuda") * 3072 ** -0.5
    out = matmul(a, b, out_dtype=BF16)
    assert out.dtype == BF16
    assert _normalised(out, matmul_ref(a, b, out_dtype=BF16)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["a", "b"])
def test_matmul_stream_unaligned_operand_takes_simt_on_card(which, cuda_device):
    """An fp32 operand 4 bytes off a 16-byte boundary cannot be read by TMA:
    the product takes simt and still matches."""
    _mm_on_card(4, 512, 256, "simt", shift=which)


@pytest.mark.cuda
def test_matmul_stream_is_deterministic_on_card(cuda_device):
    """Split K adds the partials in a fixed order: two calls are bit-equal."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    a, b = torch.randn((4, 12288), generator=gen, device="cuda"), \
        torch.randn((12288, 3072), generator=gen, device="cuda")
    assert mm_launcher.plan_for(a, b).splits > 1
    assert torch.equal(matmul(a, b), matmul(a, b))


def _flash_on_card(case, seed=0):
    b, s, s_k, h, kv, hd, causal, win = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    k, v = (torch.randn((b, s_k, kv, hd), generator=gen, device="cuda") for _ in range(2))
    assert fl_launcher.plan_for(q, k, v) == "tf32x3"
    before, by = flash_attention.launches, dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_route["tf32x3"] == by["tf32x3"] + 1
    assert _normalised(out, attention_ref(q, k, v, causal=causal, window=win)) <= FP32_GATE
    assert _normalised(out, attention_f64(q, k, v, causal=causal, window=win)) <= FP32_ACCURATE
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 512, 512, 24, 2, 128, True, None),  # StarCoder2's prefill
                                  (4, 512, 512, 32, 32, 80, True, None)])  # Zamba2's
def test_flash_tf32x3_prefill_on_card(case, cuda_device):
    _flash_on_card(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + [(4, 448, 1500, 8, 8, 64, False, None),
                                                (1, 100, 100, 2, 1, 72, True, None),
                                                (1, 40, 100, 4, 2, 32, True, 16)])
def test_flash_tf32x3_masks_on_card(case, cuda_device):
    """Causal, a window, S < Sk (Whisper's cross-attention), GQA, no mask,
    and hd 72 and 32 (a partial last atom; one atom)."""
    _flash_on_card(case, seed=sum(case[:6]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES[:2])
def test_flash_tf32x3_matches_emulation_on_card(case, cuda_device):
    """The kernel against the plain-torch emulation of its arithmetic."""
    out = _flash_on_card(case, seed=7)
    b, s, s_k, h, kv, hd, causal, win = case
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    k, v = (torch.randn((b, s_k, kv, hd), generator=gen, device="cuda") for _ in range(2))
    emu = flash_attention_tf32x3(q.cpu(), k.cpu(), v.cpu(), causal=causal, window=win)
    assert _normalised(out, emu) <= FP32_ACCURATE


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 80, 64])
def test_flash_tf32x3_row_without_keys_is_zero_on_card(hd, cuda_device):
    """Queries before the key timeline (S > Sk, causal) see no key: exactly
    0, and the other rows match the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(hd)
    q = torch.randn((1, 150, 2, hd), generator=gen, device="cuda")
    k, v = (torch.randn((1, 100, 1, hd), generator=gen, device="cuda") for _ in range(2))
    assert fl_launcher.plan_for(q, k, v) == "tf32x3"
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert bool((out[:, :50] == 0).all())
    assert _normalised(out[:, 50:], attention_ref(q[:, 50:], k, v, causal=True)) <= FP32_GATE
