"""The port's flash attention (repro_torch.kernels.flash_attention) against
the JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py
runs it), its oracle ``attention_ref`` and ``layers.gqa_attention``, on the
same numpy inputs. On the CPU the port's wrappers take their plain version;
the CUDA kernel itself is checked by the ``cuda``-marked cases."""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as launcher  # noqa: E402
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
# The wgmma route at the models' head dims, 128 (StarCoder2) and 80 (Zamba2),
# at small S: S not a multiple of the 128-row query block, S < Sk, a
# window, no mask: (b, s, s_k, h, kv, hd, causal, window).
HD_CASES = [(1, 200, 200, 4, 2, 128, True, None), (2, 130, 130, 4, 4, 80, True, None),
            (1, 150, 150, 2, 2, 80, True, 64), (1, 60, 150, 3, 1, 128, True, 32),
            (1, 90, 170, 2, 2, 80, True, None), (1, 77, 77, 2, 1, 80, False, None),
            (1, 100, 100, 2, 1, 72, True, None)]  # hd % 16 == 8: a half-zero last step
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16, FP32 = torch.bfloat16, torch.float32


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


# ---------------------------------------------------------------------------
# The plan and the launch path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd, dtype, aligned, route", [
    (128, BF16, True, "wgmma"),  # StarCoder2
    (80, BF16, True, "wgmma"),  # Zamba2: two atoms, the second zero-filled past 80
    (64, BF16, True, "wgmma"),
    (48, BF16, True, "wgmma"),  # one atom, zero-filled past 48
    (32, BF16, True, "wgmma"),
    (120, BF16, True, "wgmma"),  # hd % 8 == 0: rows of 16-byte multiples
    (8, BF16, True, "wgmma"),
    (128, FP32, True, "tf32x3"),  # fp32 as three TF32 products on the tensor cores
    (80, FP32, True, "tf32x3"),
    (32, FP32, True, "tf32x3"),
    (64, FP32, True, "tf32x3"),  # Whisper
    (8, FP32, True, "tf32x3"),
    (128, FP32, False, "simt"),
    (100, FP32, True, "simt"),
    (136, FP32, True, "simt"),
    (128, BF16, False, "simt"),  # q, k or v off 16 bytes: TMA cannot read it
    (100, BF16, True, "simt"),  # hd % 8 == 4: rows not 16-byte multiples
    (36, BF16, True, "simt"),
    (136, BF16, True, "simt"),  # past two atoms
    (256, BF16, True, "simt"),
])
def test_flash_plan_route(hd, dtype, aligned, route):
    assert launcher.plan(hd, dtype, aligned) == route


def test_flash_tile_constants_match_kernel():
    """The query rows per block and keys per tile that the emulation below
    walks are the kernel's own."""
    src = (Path(launcher.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    wg = src[src.index("namespace wg {"):]
    for name, value in (("BQ", launcher.BQ), ("BK", launcher.BK)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", wg).group(1)) == value


def test_flash_plan_for_reads_alignment():
    """plan_for takes the route from the tensors: an operand 2 bytes off a
    16-byte boundary (a view one element in) goes to simt; fp32 to tf32x3."""
    q, k, v = (torch.zeros((1, 8, 2, 64), dtype=BF16) for _ in range(3))
    assert launcher.plan_for(q, k, v) == "wgmma"
    off = torch.zeros(1 * 8 * 2 * 64 + 1, dtype=BF16)[1:].view(1, 8, 2, 64)
    assert launcher.plan_for(q, off, v) == "simt"
    assert launcher.plan_for(q.float(), k.float(), v.float()) == "tf32x3"


def test_flash_plan_is_cached():
    """The plan of a head dim, dtype and alignment is computed once."""
    launcher.plan(128, BF16, True)
    hits = launcher.plan.cache_info().hits
    for _ in range(3):
        launcher.plan(128, BF16, True)
    assert launcher.plan.cache_info().hits == hits + 3


class _FakeLib:
    """Stands in for the CUDA library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def repro_flash_attention(self, *args):
        self.calls.append(args)
        return 0

    def repro_flash_attention_tf32x3(self, *args):  # the four split parts after q, k, v, out
        self.calls.append(args[:4] + args[8:17] + (launcher.DTYPE_CODES[FP32],
                                                   launcher.ROUTES["tf32x3"]) + args[17:])
        return 0


@pytest.mark.parametrize("shape, dtype, causal, window", [
    ((4, 512, 24, 2, 128), BF16, True, None),
    ((4, 512, 32, 32, 80), BF16, True, None),
    ((1, 40, 4, 2, 32), FP32, True, 16),
    ((2, 96, 4, 4, 100), BF16, False, None),
])
def test_flash_launch_is_one_library_call(shape, dtype, causal, window, monkeypatch):
    """A launch is one call into the library, with the plan's route, the
    shape, the mask and 1 / sqrt(hd)."""
    fake = _FakeLib()
    monkeypatch.setattr(launcher, "_lib", lambda: fake)
    b, s, h, kv, hd = shape
    q, out = torch.zeros((b, s, h, hd), dtype=dtype), torch.empty((b, s, h, hd), dtype=dtype)
    k, v = torch.zeros((b, s, kv, hd), dtype=dtype), torch.zeros((b, s, kv, hd), dtype=dtype)
    route = launcher.plan_for(q, k, v)
    launcher.launch(q, k, v, out, route, 0, causal=causal, window=window)
    assert len(fake.calls) == 1
    (pq, pk, pv, po, cb, cs, csk, ch, ckv, chd, ccausal, cwin, scale, dt, croute, dev,
     stream) = fake.calls[0]
    assert (pq, pk, pv, po) == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert (cb, cs, csk, ch, ckv, chd) == (b, s, s, h, kv, hd)
    assert (ccausal, cwin) == (int(causal), window or 0)
    assert scale == pytest.approx(1 / math.sqrt(hd))
    assert (dt, croute) == (launcher.DTYPE_CODES[dtype], launcher.ROUTES[route])
    assert route == ("simt" if hd % 8 else "wgmma" if dtype == BF16 else "tf32x3")
    assert (dev, stream) == (0, 0)


def test_flash_cpu_counts_no_launch():
    """On the CPU the wrapper takes the plain version and counts no launch."""
    before, by_route = flash_attention.launches, dict(flash_attention.launches_by_route)
    q = torch.ones((1, 8, 4, 16), dtype=BF16)
    flash_attention(q, torch.ones((1, 8, 2, 16), dtype=BF16), torch.ones((1, 8, 2, 16), dtype=BF16))
    assert flash_attention.launches == before
    assert flash_attention.launches_by_route == by_route


# ---------------------------------------------------------------------------
# The wgmma route's tiling, in plain torch
# ---------------------------------------------------------------------------


def _box(x, rows, n):
    """The TMA box of rows ``rows`` (all columns, zero-filled to n) of a (T,
    hd) matrix: zero where a row is past the end."""
    out = torch.zeros((len(rows), n))
    ok = rows < x.shape[0]
    out[ok, :x.shape[1]] = x[rows[ok]].float()
    return out


def emulate_wgmma(q, k, v, *, causal, window):
    """The wgmma route in plain torch, walked as ``flash_attention.cu::wg::flash_wgmma``
    walks it: blocks of 128 query rows, two warpgroups of 64; the key range
    the block can see in tiles of ``BK`` keys from t_lo (floored to a tile);
    tiles fully masked for a warpgroup skipped; hd zero-filled to whole
    atoms and Q K^T over ceil(hd / 16) steps of 16; scores in log2 units,
    the mask applied only on tiles that cut the diagonal, the window's edge
    or Sk; exp2, P rounded to bf16 before PV, the sum from the fp32 P; the
    epilogue's 1 / max(l, 1e-30), rows past S masked. Every output row must
    be written once: the output starts as NaN."""
    b, s, h, hd = q.shape
    _, sk, kv, _ = k.shape
    bq, bk = launcher.BQ, launcher.BK
    n = -(-hd // 64) * 64  # hd in whole 64-wide atoms (128-byte swizzle rows)
    kd = -(-hd // 16) * 16
    scale_log2 = (1.0 / math.sqrt(hd)) * math.log2(math.e)
    shift = sk - s
    out = torch.full((b, s, h, hd), float("nan"))
    for bi in range(b):
        for hi in range(h):
            g = hi // (h // kv)
            kf, vf = k[bi, :, g], v[bi, :, g]
            for q0 in range(0, s, bq):
                pos_lo, pos_hi = q0 + shift, min(q0 + bq, s) - 1 + shift
                t_hi = min(sk, pos_hi + 1) if causal else sk
                t_lo = max(0, pos_lo - window + 1) // bk * bk if window else 0
                n_tiles = -(-(t_hi - t_lo) // bk) if t_hi > t_lo else 0
                for wgi in range(2):
                    r_wg = q0 + 64 * wgi
                    w_lo, w_hi = r_wg + shift, r_wg + 63 + shift
                    rows = r_wg + torch.arange(64)
                    pos = rows + shift
                    qt = _box(q[bi, :, hi], rows, n)
                    m, l = torch.full((64,), float("-inf")), torch.zeros(64)
                    acc = torch.zeros((64, n))
                    for it in range(n_tiles):
                        t0 = t_lo + it * bk
                        if (r_wg >= s or t0 >= sk or (causal and t0 > w_hi)
                                or (window and t0 + bk - 1 <= w_lo - window)):
                            continue
                        keys = t0 + torch.arange(bk)
                        kt, vt = _box(kf, keys, n), _box(vf, keys, n)
                        sc = (qt[:, :kd] @ kt[:, :kd].T) * scale_log2
                        if (t0 + bk > sk or (causal and t0 + bk - 1 > w_lo)
                                or (window and t0 <= w_hi - window)):
                            ok = keys[None] < sk
                            if causal:
                                ok = ok & (keys[None] <= pos[:, None])
                            if window:
                                ok = ok & (keys[None] > pos[:, None] - window)
                            sc = sc.masked_fill(~ok, float("-inf"))
                        mx = torch.maximum(m, sc.max(1).values)
                        mu = torch.where(mx == float("-inf"), 0.0, mx)
                        alpha = torch.exp2(m - mu)
                        m = mx
                        pr = torch.exp2(sc - mu[:, None])
                        l = l * alpha + pr.sum(1)
                        acc = acc * alpha[:, None] + pr.to(BF16).float() @ vt
                    o = acc / l.clamp(min=1e-30)[:, None]
                    keep = rows < s
                    out[bi, rows[keep], hi] = o[keep, :hd]
    assert not torch.isnan(out).any(), "an output row no block wrote"
    return out.to(q.dtype)


@pytest.mark.parametrize("case", [(b, s, s, h, kv, hd, c, w) for b, s, h, kv, hd, c, w in ATTN_CASES]
                         + [(b, s, sk, h, kv, hd, True, w) for b, s, sk, h, kv, hd, w in SHORT_Q_CASES]
                         + HD_CASES)
def test_wgmma_tiling_matches_ref_and_jax(case, jax):
    """The emulation against attention_ref and, at S = Sk, the JAX Pallas
    kernel (interpret mode), at the bf16 tolerance, on bf16 inputs."""
    b, s, s_k, h, kv, hd, causal, win = case
    (q, k, v), (qt, kt, vt) = _inputs(b, s, s_k, h, kv, hd, "bfloat16")
    out = emulate_wgmma(qt, kt, vt, causal=causal, window=win)
    assert out.dtype == BF16 and out.shape == (b, s, h, hd)
    ref = attention_ref(qt, kt, vt, causal=causal, window=win)
    torch.testing.assert_close(out.float(), ref.float(), **_tol("bfloat16"))
    if s == s_k:
        from repro.kernels.flash_attention.ops import flash_attention as jax_flash
        qj, kj, vj = (jax.numpy.asarray(a, "bfloat16") for a in (q, k, v))
        pallas = jax_flash(qj, kj, vj, causal=causal, window=win, bq=32, bk=32)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(pallas, np.float32),
                                   **_tol("bfloat16"))


def test_wgmma_tiling_row_without_keys_is_zero():
    """Queries before the key timeline (S > Sk, causal) see no key: the
    emulated route gives exactly 0 there, as the kernel must."""
    _, (qt, kt, vt) = _inputs(1, 150, 100, 2, 1, 80, "bfloat16")
    out = emulate_wgmma(qt, kt, vt, causal=True, window=None)
    assert (out[:, :50] == 0).all()
    ref = attention_ref(qt[:, 50:], kt, vt, causal=True)  # rows 50.. at positions 0..
    torch.testing.assert_close(out[:, 50:].float(), ref.float(), **_tol("bfloat16"))


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
@pytest.mark.parametrize("case", [(b, s, s, h, kv, hd, c, w) for b, s, h, kv, hd, c, w in ATTN_CASES]
                         + [(b, s, sk, h, kv, hd, True, w)
                            for b, s, sk, h, kv, hd, w in SHORT_Q_CASES]
                         + [(2, 200, 200, 8, 2, 120, True, 64), (1, 300, 300, 2, 1, 256, True, None)]
                         + HD_CASES + [(1, 70, 70, 2, 2, 100, True, None)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_flash_attention_kernel_matches_plain_on_card(case, name, cuda_device):
    """Each case launches once, on the route its plan names: with hd % 8 == 0
    and hd <= 128 wgmma for bf16 and tf32x3 for fp32, simt for the rest."""
    b, s, s_k, h, kv, hd, causal, win = case
    _, ts = _inputs(b, s, s_k, h, kv, hd, name)
    qt, kt, vt = (t.to(cuda_device) for t in ts)
    route = "simt"
    if hd % 8 == 0 and hd <= 128:
        route = "wgmma" if name == "bfloat16" else "tf32x3"
    assert launcher.plan_for(qt, kt, vt) == route
    before, by_route = flash_attention.launches, dict(flash_attention.launches_by_route)
    out = flash_attention(qt, kt, vt, causal=causal, window=win)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_route[route] == by_route[route] + 1
    torch.testing.assert_close(out.float(),
                               attention_ref(qt, kt, vt, causal=causal, window=win).float(),
                               **_tol(name))


@pytest.mark.cuda
@pytest.mark.parametrize("case", HD_CASES[:4] + [ATTN_CASES[2][:2] + ATTN_CASES[2][1:]])
def test_flash_wgmma_matches_emulation_on_card(case, cuda_device):
    """The wgmma kernel at hd 128, 80 and 64 against the plain version and
    the plain-torch emulation of its tiling."""
    b, s, s_k, h, kv, hd, causal, win = case
    _, ts = _inputs(b, s, s_k, h, kv, hd, "bfloat16")
    qt, kt, vt = (t.to(cuda_device) for t in ts)
    out = torch.empty_like(qt)
    launcher.launch(qt, kt, vt, out, "wgmma", torch.cuda.current_stream().cuda_stream,
                    causal=causal, window=win)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               attention_ref(qt, kt, vt, causal=causal, window=win).float(),
                               **_tol("bfloat16"))
    emu = emulate_wgmma(*ts, causal=causal, window=win)
    torch.testing.assert_close(out.float().cpu(), emu.float(), **_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("hd", [128, 80])
def test_flash_row_without_keys_is_zero_on_card(name, hd, cuda_device):
    """Queries before the key timeline (S > Sk, causal) see no key: exactly 0
    on either route, and the other rows match the plain version."""
    _, ts = _inputs(1, 150, 100, 2, 1, hd, name)
    qt, kt, vt = (t.to(cuda_device) for t in ts)
    out = flash_attention(qt, kt, vt, causal=True)
    torch.cuda.synchronize()
    assert bool((out[:, :50] == 0).all())
    torch.testing.assert_close(out[:, 50:].float(),
                               attention_ref(qt[:, 50:], kt, vt, causal=True).float(),
                               **_tol(name))
