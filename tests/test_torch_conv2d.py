"""The port's conv (repro_torch.kernels.conv2d) against the JAX package's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and its
lax oracle, on the same numpy inputs. On the CPU the port's wrapper takes
its plain version; the CUDA kernel itself is checked by the ``cuda``-marked
cases, which run only on a machine with a card. The wgmma route's plan is
checked here, and its tiling by a plain-torch emulation that walks the
kernel's tiles, taps, zero-filled boxes, masked epilogue and split order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d import conv2d as launcher  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402

# (N, C, H, W, K, R): tests/test_kernels.py::CONV_CASES plus an even R,
# whose "same" padding is uneven ((R-1)//2 before, R//2 after).
CONV_CASES = [(1, 16, 16, 16, 32, 3), (2, 3, 20, 24, 64, 5),
              (1, 8, 10, 10, 16, 1), (1, 64, 7, 9, 8, 7), (1, 12, 9, 11, 24, 4)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (N, C, H, W, K, R) the wgmma route takes (bf16, C % 64 == 0, K % 8 == 0):
# C of one and two 64-channel steps; K of 8 (under one 64-wide atom), 64
# (one atom, half a tile), 200 (a ragged second tile); R of 1, 3, 4 (uneven
# padding) and 7 (a halo wider than half the image); odd H and W, images
# narrower than a box, several boxes across both axes, batch 2.
WGMMA_CASES = [(2, 64, 9, 11, 64, 3), (1, 128, 7, 13, 200, 3), (2, 64, 5, 7, 8, 1),
               (1, 64, 12, 10, 72, 4), (1, 128, 6, 9, 136, 7), (1, 64, 30, 33, 128, 3),
               (2, 128, 17, 19, 64, 3)]
BF16, FP32 = torch.bfloat16, torch.float32
H100_SMS = 132


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


# ---------------------------------------------------------------------------
# The wgmma route's plan and tiling, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c, k, dtype, route", [
    (64, 64, BF16, "wgmma"),
    (64, 64, FP32, "tf32x3"),  # fp32 split into TF32 halves on the tensor cores
    (3, 64, FP32, "direct"),  # VGG's first layer stays on the CUDA cores in fp32 too
    (48, 64, FP32, "direct"),  # C % 32 == 16
    (96, 64, FP32, "tf32x3"),  # C % 32 == 0
    (64, 12, FP32, "tf32x3"),  # any K: the weights go K-major
    (3, 64, BF16, "direct"),  # VGG's first layer
    (96, 64, BF16, "direct"),  # C % 64 == 32
    (128, 64, BF16, "wgmma"),
    (512, 512, BF16, "wgmma"),
    (64, 8, BF16, "wgmma"),  # K % 8 == 0
    (64, 12, BF16, "direct"),  # K % 8 == 4: weight rows not 16 bytes
    (64, 200, BF16, "wgmma"),
    (8, 16, BF16, "direct"), (12, 24, BF16, "direct"), (16, 32, BF16, "direct"),
])
def test_conv2d_plan_route(c, k, dtype, route):
    p = launcher.plan(8, c, 56, 56, k, 3, 3, dtype, H100_SMS)
    assert p.route == route
    assert (p.box == ()) == (route == "direct") and p.splits >= 1


@pytest.mark.parametrize("k, tile_n", [(8, 64), (64, 64), (72, 128), (128, 128),
                                       (512, 128)])
def test_conv2d_plan_tile_n(k, tile_n):
    """64 output channels a block where K <= 64, else 128."""
    assert launcher.plan(8, 64, 224, 224, k, 3, 3, BF16, H100_SMS).tile_n == tile_n


@pytest.mark.parametrize("h, w, box", [
    (224, 224, (32, 4)),  # 7 x 56 boxes, no waste; ties with 16 x 8, the wider wins
    (112, 112, (16, 8)),  # 7 x 14, no waste (32 x 4 would need 4 x 28)
    (56, 56, (64, 2)),  # 28 boxes, as 16 x 8 and 32 x 4; the wider wins
    (28, 28, (32, 4)),  # 7 boxes (16 x 8 needs 8)
    (14, 14, (16, 8)),  # 2 boxes
    (7, 9, (16, 8)),  # smaller than one box
    (30, 33, (4, 32)),  # 9 boxes: narrow columns
    (9, 300, (64, 2)),  # 5 x 5 boxes (128 x 1 needs 3 x 9)
    (1, 1, (128, 1)),
])
def test_conv2d_plan_box(h, w, box):
    assert launcher.pick_box(h, w) == box
    assert launcher.plan(2, 64, h, w, 64, 3, 3, BF16, H100_SMS).box == box
    assert box[0] * box[1] == launcher.TILE_M


@pytest.mark.parametrize("shape, splits, blocks", [
    ((8, 512, 14, 14, 512, 3), 2, 1),  # 64 tiles on 132 SMs: 2 splits of 36 steps
    ((8, 512, 28, 28, 512, 3), 1, 2),  # 224 tiles fill the card: two blocks per SM
    ((8, 256, 28, 28, 512, 3), 1, 2),
    ((8, 64, 224, 224, 64, 3), 1, 2),
    ((1, 512, 14, 14, 512, 3), 15, 1),  # 8 tiles: 15 splits of 5 steps, one wave
    ((2, 64, 9, 11, 64, 3), 2, 1),  # 9 steps: no split below 4 steps
    ((2, 64, 5, 7, 8, 1), 1, 1),  # 1 step
    ((1, 128, 6, 9, 136, 7), 20, 1),  # 98 steps: the 24 splits allowed settle to 20 of 5
    ((1, 64, 30, 33, 128, 3), 2, 1),
    ((17, 512, 14, 14, 512, 3), 1, 2),  # 136 tiles fill the card
    ((16, 512, 14, 14, 512, 3), 1, 1),  # 128 tiles: 2 splits would take two waves
])
def test_conv2d_plan_splits(shape, splits, blocks):
    n, c, h, w, k, r = shape
    p = launcher.plan(n, c, h, w, k, r, r, BF16, H100_SMS)
    steps = r * r * c // launcher.BK
    chunk = launcher.kchunk(steps, p.splits)
    # every split is at least MIN_SPLIT_STEPS deep unless the steps are not
    # cut, none is empty, and the count comes back from its own chunk
    assert p.splits == 1 or chunk >= launcher.MIN_SPLIT_STEPS
    assert (p.splits - 1) * chunk < steps <= p.splits * chunk
    assert (p.splits, p.blocks) == (splits, blocks)


def _tma_box(img, c0, w_start, h_start, bw, bh):
    """The (bh, bw, 64) box of an (H, W, C) image that a 4-D TMA load reads
    at signed coordinates (c0, w_start, h_start): zero outside the image."""
    h, w, _ = img.shape
    out = torch.zeros((bh, bw, launcher.BK), dtype=img.dtype)
    hs, he = max(h_start, 0), min(h_start + bh, h)
    ws, we = max(w_start, 0), min(w_start + bw, w)
    if hs < he and ws < we:
        out[hs - h_start:he - h_start, ws - w_start:we - w_start] = \
            img[hs:he, ws:we, c0:c0 + launcher.BK]
    return out


def emulate_wgmma(x, w, p):
    """The wgmma route in plain torch, walked as ``conv2d.cu::wg::conv2d_wgmma``
    walks it: blocks with the output-channel tile fastest, then box column,
    box row and image; per split its K steps, step -> (tap, channel chunk),
    the A box zero-filled off the image and the B rows t*C + c0; the
    epilogue's row -> pixel map with pixels past H or W and channels past K
    masked; the partials added in split order. Every element of every split
    must be written once: the workspace starts as NaN."""
    n, c, h, wd = x.shape
    k, _, r, s = w.shape
    tm, tn, bk = launcher.TILE_M, p.tile_n, launcher.BK
    xh, wm = (t.float() for t in launcher.wgmma_operands(x, w))
    bw, bh = p.box
    pt, pl = (r - 1) // 2, (s - 1) // 2
    tiles_w, tiles_h, tiles_k = -(-wd // bw), -(-h // bh), -(-k // tn)
    steps, chunks = r * s * c // bk, c // bk
    chunk = launcher.kchunk(steps, p.splits)
    ws = torch.full((p.splits, n, k, h, wd), float("nan"))
    rows = torch.arange(tm)
    for block in range(tiles_k * tiles_w * tiles_h * n):
        n0, rest = (block % tiles_k) * tn, block // tiles_k
        w0, rest = (rest % tiles_w) * bw, rest // tiles_w
        h0, img = (rest % tiles_h) * bh, rest // tiles_h
        ph, pw = h0 + rows // bw, w0 + rows % bw
        cols = n0 + torch.arange(tn)
        keep_r, keep_c = (ph < h) & (pw < wd), cols < k
        for z in range(p.splits):
            acc = torch.zeros((tm, tn))
            for step in range(z * chunk, min(steps, (z + 1) * chunk)):
                t, c0 = step // chunks, (step % chunks) * bk
                a = _tma_box(xh[img], c0, w0 + t % s - pl, h0 + t // s - pt, bw, bh)
                b = torch.zeros((bk, tn))
                part = wm[t * c + c0:t * c + c0 + bk, n0:n0 + tn]
                b[:, :part.shape[1]] = part
                acc += a.reshape(tm, bk) @ b
            sel_c = cols[keep_c]
            ws[z, img, sel_c[:, None], ph[keep_r][None], pw[keep_r][None]] = \
                acc[keep_r][:, keep_c].T
    assert not torch.isnan(ws).any(), "an output element no block wrote"
    out = ws[0]
    for z in range(1, p.splits):
        out = out + ws[z]
    return out.to(x.dtype)


@pytest.mark.parametrize("case", WGMMA_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_wgmma_tiling_matches_ref_and_jax(case, name, jnp):
    """The emulation on the plan the card would take (its box and splits)
    against conv2d_ref and the JAX Pallas kernel; fp32 inputs hold the index
    arithmetic to 2e-4."""
    from repro.kernels.conv2d.ops import conv2d as jax_conv2d
    n, c, h, w, k, r = case
    x, wt, xt, wtt = _inputs(case, name)
    p = launcher.plan(n, c, h, w, k, r, r, BF16, H100_SMS)
    assert p.route == "wgmma"
    out = emulate_wgmma(xt, wtt, p)
    assert out.dtype == DTYPES[name] and out.shape == (n, k, h, w)
    torch.testing.assert_close(out.float(), conv2d_ref(xt, wtt).float(), **_tol(name))
    pallas = np.asarray(jax_conv2d(jnp.asarray(x, name), jnp.asarray(wt, name), bk=8),
                        np.float32)
    np.testing.assert_allclose(out.float().numpy(), pallas, **_tol(name))


@pytest.mark.parametrize("box", launcher.BOXES)
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("tile_n", launcher.TILES_N)
def test_wgmma_tiling_every_box(box, splits, tile_n):
    """Every box the kernel can take, whole and in 3 splits, in tiles of 128
    and 64 output channels, on an image that no box covers evenly, with an
    even R and K = 72 (a ragged last tile either way)."""
    case = (2, 128, 10, 13, 72, 4)
    _, _, xt, wt = _inputs(case, "float32", seed=1)
    out = emulate_wgmma(xt, wt, launcher.Plan("wgmma", box, splits, 1, tile_n))
    torch.testing.assert_close(out, conv2d_ref(xt, wt), **_tol("float32"))


def test_conv2d_plan_is_cached():
    """The plan of a shape is computed once per card and shape."""
    launcher.plan(8, 512, 14, 14, 512, 3, 3, BF16, H100_SMS)
    hits = launcher.plan.cache_info().hits
    for _ in range(3):
        launcher.plan(8, 512, 14, 14, 512, 3, 3, BF16, H100_SMS)
    assert launcher.plan.cache_info().hits == hits + 3


class _FakeLib:
    """Stands in for the CUDA library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def repro_conv2d(self, *args):
        self.calls.append(("direct", args))
        return 0

    def repro_conv2d_wgmma(self, *args):
        self.calls.append(("wgmma", args))
        return 0

    def repro_conv2d_tf32x3(self, *args):
        self.calls.append(("tf32x3", args))
        return 0


@pytest.mark.parametrize("shape, dtype", [((8, 512, 14, 14, 512, 3), BF16),
                                          ((2, 64, 9, 11, 64, 3), BF16),
                                          ((2, 64, 9, 11, 64, 3), FP32),
                                          ((1, 3, 9, 11, 64, 3), BF16),
                                          ((1, 3, 9, 11, 64, 3), FP32)])
def test_conv2d_launch_is_one_library_call(shape, dtype, monkeypatch):
    """A launch is one call into the library, on the plan's route, with its
    box, splits and blocks per SM, scratch for the NHWC and (R*S*C, K)
    operands the call writes, and a workspace exactly when the steps are
    split."""
    import types
    fake = _FakeLib()
    monkeypatch.setattr(launcher, "_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    n, c, h, w, k, r = shape
    x, wt = torch.zeros((n, c, h, w), dtype=dtype), torch.zeros((k, c, r, r), dtype=dtype)
    out = torch.empty((n, k, h, w), dtype=dtype)
    p = launcher.plan(n, c, h, w, k, r, r, dtype, H100_SMS)
    launcher.launch(x, wt, out, p)
    assert len(fake.calls) == 1
    route, args = fake.calls[0]
    assert route == p.route
    if route == "wgmma":
        (px, pw, py, pxt, pwt, ws, *dims, bw, bh, splits, blocks, tile_n, dev, stream) = args
        assert (px, pw, py) == (x.data_ptr(), wt.data_ptr(), out.data_ptr())
        assert len({px, pw, py, pxt, pwt}) == 5 and (pxt | pwt) % 16 == 0
        assert (bw, bh, splits, blocks, tile_n) == (*p.box, p.splits, p.blocks, p.tile_n)
        assert (ws is None) == (p.splits == 1) and (ws is None or ws % 16 == 0)
    elif route == "tf32x3":
        (px, pw, py, *parts, ws), dims = args[:8], list(args[8:15])
        (bw, bh, splits, tile_n, dev, stream) = args[15:]
        assert (px, pw, py) == (x.data_ptr(), wt.data_ptr(), out.data_ptr())
        assert len({px, pw, py, *parts}) == 7 and all(v % 16 == 0 for v in parts)
        assert (bw, bh, splits, tile_n) == (*p.box, p.splits, p.tile_n)
        assert (ws is None) == (p.splits == 1) and (ws is None or ws % 16 == 0)
    else:
        (px, pw, py, *dims, dtype_code, dev, stream) = args
        assert (px, pw, py) == (x.data_ptr(), wt.data_ptr(), out.data_ptr())
        assert dtype_code == launcher.DTYPE_CODES[dtype]
    assert dims == [n, c, h, w, k, r, r] and (dev, stream) == (0, 0)


def test_wgmma_operands_layout():
    """x goes to NHWC; w's row t*C + c, t = r*S + s, holds w[:, c, r, s]."""
    x = torch.arange(2 * 64 * 3 * 5, dtype=FP32).reshape(2, 64, 3, 5)
    w = torch.arange(8 * 64 * 3 * 2, dtype=FP32).reshape(8, 64, 3, 2)
    xh, wm = launcher.wgmma_operands(x, w)
    assert xh.is_contiguous() and torch.equal(xh[1, 2, 4], x[1, :, 2, 4])
    assert wm.shape == (3 * 2 * 64, 8) and wm.is_contiguous()
    for r, s, c in [(0, 0, 0), (2, 1, 63), (1, 0, 5)]:
        assert torch.equal(wm[(r * 2 + s) * 64 + c], w[:, c, r, s])


def test_conv2d_cpu_counts_no_launch():
    """On the CPU the wrapper takes the plain version and counts no launch."""
    before, by_route = conv2d.launches, dict(conv2d.launches_by_route)
    conv2d(torch.ones((1, 64, 5, 5), dtype=BF16), torch.ones((8, 64, 3, 3), dtype=BF16))
    assert conv2d.launches == before and conv2d.launches_by_route == by_route


# ---------------------------------------------------------------------------
# The wgmma route on the card
# ---------------------------------------------------------------------------


def _check_on_card(x, w, route, plan=None):
    """One call on the card: one launch on ``route`` (or of ``plan``), within
    the bf16 tolerance of the plain version on the same inputs."""
    if plan is None:
        before, by_route = conv2d.launches, dict(conv2d.launches_by_route)
        out = conv2d(x, w)
        torch.cuda.synchronize()
        assert conv2d.launches == before + 1
        assert conv2d.launches_by_route[route] == by_route[route] + 1, conv2d.launches_by_route
    else:
        out = torch.empty((x.shape[0], w.shape[0], *x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        launcher.launch(x, w, out, plan)
        torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), conv2d_ref(x, w).float(), **_tol("bfloat16"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("c, tap", [(64, (1, 1)), (64, (0, 0)), (64, (2, 2)), (64, (0, 2)),
                                    (128, (2, 0)), (128, (1, 1))])
def test_conv2d_wgmma_probe_on_card(c, tap, cuda_device):
    """Exact, before any random data: a 3x3 weight that is the identity over
    channels at one tap and zero elsewhere shifts the image by that tap,
    with zeros where the box runs off it (the halo TMA fills). Small
    integers are exact in bf16, so the kernel must equal the plain version
    bit for bit; each channel of two 64-channel steps checks B's rows."""
    n, h, w = 2, 9, 11
    idx = torch.stack(torch.meshgrid(*(torch.arange(d) for d in (n, c, h, w)), indexing="ij"))
    x = ((idx[0] * 7 + idx[1] * 3 + idx[2] * 5 + idx[3]) % 17 - 8).to(BF16).to(cuda_device)
    wt = torch.zeros((c, c, 3, 3), dtype=BF16)
    wt[torch.arange(c), torch.arange(c), tap[0], tap[1]] = 1
    wt = wt.to(cuda_device)
    out = _check_on_card(x, wt, "wgmma")
    assert torch.equal(out, conv2d_ref(x, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES + [(8, 512, 14, 14, 512, 3)])
def test_conv2d_relayout_on_card(case, cuda_device):
    """The route's re-layout kernel gives wgmma_operands bit for bit."""
    _, _, xt, wt = _inputs(case, "bfloat16")
    xt, wt = xt.to(cuda_device), wt.to(cuda_device)
    got = launcher.relayout(xt, wt)
    torch.cuda.synchronize()
    for a, b in zip(got, launcher.wgmma_operands(xt, wt)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_conv2d_wgmma_matches_plain_on_card(case, cuda_device):
    _, _, xt, wt = _inputs(case, "bfloat16")
    _check_on_card(xt.to(cuda_device), wt.to(cuda_device), "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("box", launcher.BOXES)
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("blocks", launcher.BLOCKS_PER_SM)
@pytest.mark.parametrize("tile_n", launcher.TILES_N)
def test_conv2d_wgmma_every_box_on_card(box, splits, blocks, tile_n, cuda_device):
    _, _, xt, wt = _inputs((2, 128, 10, 13, 72, 4), "bfloat16", seed=1)
    _check_on_card(xt.to(cuda_device), wt.to(cuda_device), "wgmma",
                   plan=launcher.Plan("wgmma", box, splits, blocks, tile_n))


@pytest.mark.cuda
def test_conv2d_wgmma_refusal_raises_on_card(cuda_device):
    """A wgmma launch the kernel refuses (C % 64 != 0) raises; nothing falls
    back to the direct kernel."""
    x = torch.zeros((1, 8, 6, 6), dtype=BF16, device=cuda_device)
    w = torch.zeros((8, 8, 3, 3), dtype=BF16, device=cuda_device)
    out = torch.empty((1, 8, 6, 6), dtype=BF16, device=cuda_device)
    with pytest.raises(RuntimeError, match="wgmma"):
        launcher.launch(x, w, out, launcher.Plan("wgmma", (16, 8), 1, 1, 128))
