"""The port's SSD chunked scan (repro_torch.kernels.ssd and models.ssm)
against the JAX package's: ``ssd_chunked`` and the Pallas ``ops.ssd`` in
interpret mode, on the same numpy inputs. On the CPU the port's wrapper
takes its plain version, ``emulate_ssd_wgmma`` walks the bf16 wgmma
route's tiling in plain torch and ``kernels.tf32.ssd_tf32x3`` the fp32
tf32x3 route's split-TF32 arithmetic; the CUDA kernels themselves are
checked by the ``cuda``-marked cases, in fp32 against float64 as well.
Tolerances: normalised max|d|/max|ref| at 1e-5 in fp32
(tests/test_kernels.py::test_ssd_matches_chunked_ref), 2e-2 in bf16.
JAX is imported by the ``jx`` fixture, not at the top: the machine with the
card has none, and the ``cuda`` cases must still run there."""
import math
import re
from functools import cache
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd import ssd as launcher  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import _segsum, ssd_chunked, ssd_ref  # noqa: E402
from repro_torch.kernels.tf32 import SSD_TILE, ssd_tf32x3  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

# tests/test_kernels.py::SSD_CASES (B, S, H, P, N, chunk), plus S < chunk
# (q = S = 100, not a multiple of the kernel's 64-row tiles).
SSD_CASES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 64, 16),
             (1, 100, 3, 16, 8, 256)]
# Zamba2-2.7B's prefill shape (batch 4 x 512, 80 heads of 64, N = 64, chunk
# 256) and ragged chunks; then Zamba2's heads in chunks of 64, 128 and 256,
# and S < chunk (q = 200: three whole tiles and a ragged one).
CARD_CASES = SSD_CASES + [(4, 512, 80, 64, 64, 256), (2, 300, 4, 24, 40, 100)]
CHUNK_CASES = [(2, 512, 8, 64, 64, 64), (2, 512, 8, 64, 64, 128), (2, 512, 8, 64, 64, 256),
               (1, 200, 4, 64, 64, 256)]
# The emulated tiling: SSD_CASES, a ragged chunk (q = 100: one whole tile
# and a ragged one), and Zamba2's P = N = 64 in chunks of 4 tiles.
TILING_CASES = SSD_CASES + [(2, 300, 4, 24, 40, 100), (1, 512, 2, 64, 64, 256)]
# The fp32 route's emulation: SSD_CASES, a ragged chunk of 100 rows in 3
# chunks, and Zamba2-2.7B's heads (P = N = 64, chunk 256) at S = 512.
TF32X3_CASES = SSD_CASES + [(2, 300, 4, 24, 40, 100), (1, 512, 3, 64, 64, 256)]
FP32, BF16 = torch.float32, torch.bfloat16
FP32_GATE = 2e-4  # normalised error of an fp32 row (tests/test_kernels.py::_tol)
FP32_ACCURATE = 1e-5  # the same against float64: what an fp32 scan reaches


@pytest.fixture
def jx():
    """The JAX package: jax, jax.numpy, its Pallas ``ops.ssd`` and ``models.ssm``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd.ops import ssd as jax_ssd
    from repro.models import ssm as jax_ssm
    return SimpleNamespace(jax=jax, jnp=jnp, ssd=jax_ssd, ssm=jax_ssm)


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
def test_ssd_matches_jax(case, jx):
    arrays = _inputs(case)
    chunk = case[-1]
    ref = jx.ssm.ssd_chunked(*(jx.jnp.asarray(a) for a in arrays), chunk)
    pallas = jx.ssd(*(jx.jnp.asarray(a) for a in arrays), chunk=chunk)
    before = ssd.launches
    out = ssd(*_torch(arrays), chunk=chunk)
    assert ssd.launches == before  # a CPU tensor takes the plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == case[:4]
    assert _err(out, ref) <= 1e-5
    assert _err(out, pallas) <= 1e-5
    assert _err(ssd_ref(*_torch(arrays), chunk=chunk), ref) <= 1e-5


@pytest.mark.parametrize("case", SSD_CASES[:2])
def test_ssd_bf16_matches_compiled_jax(case, jx):
    """bf16 x, b, c and fp32 dt, as the model calls it. Compiled, the JAX
    reference keeps C B^T in fp32; the port does so always."""
    arrays = _inputs(case)
    chunk = case[-1]
    jnp = jx.jnp
    x, dt, a_log, b, c = (jnp.asarray(a) for a in arrays)
    ref = jx.jax.jit(jx.ssm.ssd_chunked, static_argnums=5)(
        x.astype(jnp.bfloat16), dt, a_log, b.astype(jnp.bfloat16), c.astype(jnp.bfloat16), chunk)
    out = ssd(*_torch(arrays, torch.bfloat16), chunk=chunk)
    assert out.dtype == torch.bfloat16
    assert _err(out.float(), ref) <= 2e-2


def test_segsum_matches_jax(jx):
    a = np.random.default_rng(1).standard_normal((2, 3, 16)).astype(np.float32)
    ref = np.asarray(jx.ssm._segsum(jx.jnp.asarray(a)))
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


def test_ssd_decode_stepped_matches_chunked(jx):
    """tests/test_kernels.py::test_ssd_ref_matches_stepwise_recurrence on the
    port, and each step of the port's ssd_decode against JAX's."""
    b_, s, h, p, n = 1, 32, 2, 8, 4
    x, dt, _, bb, cc = _inputs((b_, s, h, p, n, 0), seed=3)
    a_log = np.random.default_rng(4).uniform(-1, 0.0, (h,)).astype(np.float32)
    arrays = (x, dt, a_log, bb, cc)
    tx, tdt, ta, tb, tc = _torch(arrays)
    ref = ssd_chunked(tx, tdt, ta, tb, tc, 8)
    state = torch.zeros((b_, h, p, n))
    jnp = jx.jnp
    jstate = jnp.zeros((b_, h, p, n), jnp.float32)
    outs = []
    for t in range(s):
        y, state = ssm.ssd_decode(state, tx[:, t], tdt[:, t], ta, tb[:, t], tc[:, t])
        jy, jstate = jx.ssm.ssd_decode(jstate, *(jnp.asarray(a[:, t]) for a in (x, dt)),
                                        jnp.asarray(a_log), jnp.asarray(bb[:, t]),
                                        jnp.asarray(cc[:, t]))
        assert _err(y, jy) <= 1e-5 and _err(state, jstate) <= 1e-5, t
        outs.append(y)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# The wgmma route's tiling, walked in plain torch
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634


def emulate_ssd_wgmma(x, dt, a_log, b, c, chunk, *, rounded=True):
    """The wgmma route in plain torch, walked as ``csrc/ssd.cu::wg`` walks it.

    ``ssd_states``, per (batch, head): chunks 0 .. NC - 2 in order, the fp32
    state scaled by exp(da_tot) and then given x^T (B o dt o exp(da_tot -
    dacum)) tile of 64 rows by tile, the B rows of the update rounded to
    bf16 and 0 past the chunk; the state entering each next chunk rounded to
    bf16. ``ssd_outputs``, per (chunk, 64-row tile i): y = exp(dacum_i)
    (C_i state^T) from that copy (chunk 0: 0), then for the column tiles j
    at or below the diagonal only, S = C_i B_j^T and G = S exp(dacum_i -
    dacum_j) dt_j: on the diagonal tile masked before the exponent (j > i,
    rows past the chunk), below it as S u_i (w_j dt_j) with u_i = exp(dacum_i
    - m), w_j = exp(m - dacum_j), m the column tile's last dacum (both at
    most 1); G rounded to bf16, y += G x_j with x as stored (dt folded into
    G). Tiles read 64 rows from their start: past a ragged chunk
    the next chunk's rows, past S zeros (TMA's fill). exp is exp2 of
    log2(e)-scaled dacum. Rows are written once each, past the chunk never:
    the output starts as NaN. ``rounded=False`` keeps every value fp32."""
    tile = launcher.TILE
    bsz, s, h, p = x.shape
    q = min(chunk, s)
    nc, nt = s // q, -(-q // tile)
    rnd = (lambda t: t.to(BF16).float()) if rounded else (lambda t: t)
    a = -torch.exp(a_log.float())
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, tile))  # rows past S: 0
    bf = torch.nn.functional.pad(b.float(), (0, 0, 0, tile))
    cf = torch.nn.functional.pad(c.float(), (0, 0, 0, tile))
    dtf = dt.float()

    def scan(ci, rows):  # dt and dacum of rows [0, rows) of chunk ci: (B, H, rows)
        d = dtf[:, ci * q:ci * q + rows].transpose(1, 2)
        return d, torch.cumsum(d * a[None, :, None], -1)

    states, acc = [], torch.zeros((bsz, h, p, b.shape[-1]))
    for ci in range(nc - 1):
        d, dac = scan(ci, q)
        w = d * torch.exp2((dac[..., -1:] - dac) * LOG2E)
        acc = acc * torch.exp2(dac[..., -1] * LOG2E)[..., None, None]
        for t in range(nt):
            r0, j = ci * q + t * tile, t * tile + torch.arange(tile)
            wt = torch.where(j < q, w[..., j.clamp(max=q - 1)], 0.0)  # (B, H, 64)
            bs = rnd(bf[:, None, r0:r0 + tile] * wt[..., None])
            acc = acc + torch.einsum("bjhp,bhjn->bhpn", xf[:, r0:r0 + tile], bs)
        states.append(rnd(acc))

    y = torch.full((bsz, s, h, p), float("nan"))
    for ci in range(nc):
        for it in range(nt):
            i0 = it * tile
            rows = min(i0 + tile, q)
            d, dac = scan(ci, rows)
            dac2 = dac * LOG2E
            ri = i0 + torch.arange(tile)
            rv = ri < q
            dr = torch.where(rv, dac2[..., ri.clamp(max=rows - 1)], 0.0)  # (B, H, 64)
            ct = cf[:, ci * q + i0:ci * q + i0 + tile]
            acc = torch.zeros((bsz, h, tile, p))
            if ci > 0:
                acc = torch.einsum("bin,bhpn->bhip", ct, states[ci - 1])
                acc = acc * torch.where(rv, torch.exp2(dr), 0.0)[..., None]
            for jt in range(it + 1):
                r0, col = ci * q + jt * tile, jt * tile + torch.arange(tile)
                sc = torch.einsum("bin,bjn->bij", ct, bf[:, r0:r0 + tile])[:, None]
                if jt == it:  # the diagonal tile: masked before the exponent
                    ok = rv[:, None] & (col[None] <= ri[:, None])  # (64, 64)
                    cc = col.clamp(max=rows - 1)
                    expo = torch.where(ok, dr[..., None] - dac2[..., None, cc], 0.0)
                    g = torch.where(ok, sc * torch.exp2(expo) * d[..., None, cc], 0.0)
                else:  # below it: u_i w_j about m, the column tile's last dacum
                    m = dac2[..., jt * tile + tile - 1, None]
                    u = torch.where(rv, torch.exp2(dr - m), 0.0)
                    w = d[..., col] * torch.exp2(m - dac2[..., col])
                    g = sc * (u[..., :, None] * w[..., None, :])
                acc = acc + torch.einsum("bhij,bjhp->bhip", rnd(g), xf[:, r0:r0 + tile])
            y[:, ci * q + ri[rv]] = acc[:, :, rv].transpose(1, 2)
    return y.to(x.dtype)


@pytest.mark.parametrize("case", TILING_CASES)
def test_wgmma_tiling_exact_matches_reference(case, jx):
    """With every value kept fp32, the emulated tiling is the reference's
    function: the port's ssd_chunked and JAX's at 1e-5."""
    arrays = _inputs(case, seed=5)
    chunk = case[-1]
    out = emulate_ssd_wgmma(*_torch(arrays), chunk, rounded=False)
    assert tuple(out.shape) == case[:4]
    assert _err(out, ssd_chunked(*_torch(arrays), chunk)) <= 1e-5
    assert _err(out, jx.ssm.ssd_chunked(*(jx.jnp.asarray(a) for a in arrays), chunk)) <= 1e-5


@pytest.mark.parametrize("case", TILING_CASES)
def test_wgmma_tiling_rounded_matches_reference(case, jx):
    """With the route's bf16 rounding points (G, the update's B rows, the
    state copy) on bf16 x, b, c: within 2e-2 of the port's ssd_chunked and of
    JAX's compiled ssd_chunked on the same inputs."""
    arrays = _inputs(case, seed=6)
    chunk = case[-1]
    tx = _torch(arrays, BF16)
    out = emulate_ssd_wgmma(*tx, chunk)
    assert out.dtype == BF16
    assert _err(out.float(), ssd_chunked(*tx, chunk).float()) <= 2e-2
    jnp = jx.jnp
    x, dt, a_log, b, c = (jnp.asarray(a) for a in arrays)
    ref = jx.jax.jit(jx.ssm.ssd_chunked, static_argnums=5)(
        x.astype(jnp.bfloat16), dt, a_log, b.astype(jnp.bfloat16), c.astype(jnp.bfloat16), chunk)
    assert _err(out.float(), ref) <= 2e-2


def _steep(case, seed=7):
    """Inputs whose decay overflows fp32 above the diagonal: a = -exp(3) and
    dt in [1, 2] make |dacum_i - dacum_j| reach ~2500 within a chunk."""
    x, dt, a_log, b, c = _inputs(case, seed)
    dt = (1.0 + dt).astype(np.float32)
    return x, dt, np.full_like(a_log, 3.0), b, c


@pytest.mark.parametrize("rounded", [False, True])
def test_wgmma_tiling_masks_before_exponent(rounded):
    """exp(dacum_i - dacum_j) above the diagonal is inf here; masked before
    the exponent the route stays finite and equal to the reference."""
    case = (1, 256, 3, 64, 64, 128)
    arrays = _steep(case)
    d = np.cumsum(arrays[1][0, :64, 0] * -math.exp(3.0))
    assert d[0] - d[-1] > math.log(np.finfo(np.float32).max)  # unmasked, exp would overflow
    tx = _torch(arrays, BF16 if rounded else torch.float32)
    out = emulate_ssd_wgmma(*tx, case[-1], rounded=rounded)
    assert torch.isfinite(out.float()).all()
    assert _err(out.float(), ssd_chunked(*tx, case[-1]).float()) <= (2e-2 if rounded else 1e-5)


def test_ssd_plan():
    """What TMA can read takes wgmma in bf16 and tf32x3 in fp32; P or N not a
    multiple of 8 or above 64, a chunk past MAX_WGMMA_Q and unaligned storage
    take simt."""
    plan = launcher.plan
    assert plan(64, 64, 256, BF16, True) == "wgmma"  # Zamba2-2.7B
    assert plan(24, 40, 100, BF16, True) == "wgmma"
    assert plan(8, 8, 1, BF16, True) == "wgmma"
    assert plan(64, 64, launcher.MAX_WGMMA_Q, BF16, True) == "wgmma"
    assert plan(64, 64, 256, torch.float32, True) == "tf32x3"
    for args in [(64, 64, 256, BF16, False),
                 (20, 64, 256, BF16, True), (64, 12, 256, BF16, True), (72, 64, 256, BF16, True),
                 (64, 64, launcher.MAX_WGMMA_Q + 1, BF16, True)]:
        assert plan(*args) == "simt", args
    x = torch.zeros((2, 512, 3, 64), dtype=BF16)
    assert tuple(launcher.state_scratch(x, 128, "wgmma").shape) == (2, 3, 3, 64, 64)
    assert launcher.state_scratch(x, 512, "wgmma") is None


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


# ---------------------------------------------------------------------------
# The fp32 route, tf32x3: its plan, scratch and launch, and its arithmetic
# walked in plain torch (``repro_torch.kernels.tf32.ssd_tf32x3``: every
# product three TF32 products a k8, each summed apart and added in fp32)
# against float64, the port's and JAX's ssd_chunked and JAX's Pallas ssd.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args, route", [
    ((24, 40, 100, FP32, True), "tf32x3"),
    ((8, 8, 1, FP32, True), "tf32x3"),
    ((16, 64, 16, FP32, True), "tf32x3"),
    ((64, 64, launcher.MAX_WGMMA_Q, FP32, True), "tf32x3"),
    ((64, 64, 256, FP32, False), "simt"),  # storage TMA cannot read
    ((20, 64, 256, FP32, True), "simt"),  # P % 8
    ((64, 12, 256, FP32, True), "simt"),  # N % 8
    ((72, 64, 256, FP32, True), "simt"),  # P past 64
    ((64, 72, 256, FP32, True), "simt"),  # N past 64
    ((64, 64, launcher.MAX_WGMMA_Q + 1, FP32, True), "simt"),  # a chunk past the row limit
])
def test_ssd_tf32x3_plan(args, route):
    assert launcher.plan(*args) == route


def test_ssd_tf32x3_plan_for_reads_alignment():
    """A tensor 4 bytes past a 16-byte boundary cannot be read by TMA."""
    x, b = torch.zeros((1, 64, 2, 16)), torch.zeros((1, 64, 8))
    assert launcher.plan_for(x, b, b, 64) == "tf32x3"
    shifted = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    assert launcher.plan_for(shifted, b, b, 64) == "simt"
    assert launcher.plan_for(x, b, torch.zeros(b.numel() + 1)[1:].view(b.shape), 64) == "simt"


def test_ssd_tf32x3_state_scratch():
    """The states entering chunks 1 .. NC - 1 as fp32 TF32 halves, hi then lo."""
    x = torch.zeros((2, 512, 3, 64))
    st = launcher.state_scratch(x, 128, "tf32x3")
    assert st.dtype == FP32 and tuple(st.shape) == (2, 2, 3, 3, 64, 64)
    assert launcher.state_scratch(x, 512, "tf32x3") is None  # one chunk: nothing to carry
    assert launcher.state_scratch(x, 128, "simt") is None


def test_ssd_tf32x3_tile_constants_match_kernel():
    """The tile the emulation walks and the row limit the plan keeps are the
    kernel's own, and the route's code is the one the entry point checks."""
    src = (Path(launcher.__file__).parent / "csrc" / "ssd.cu").read_text()
    wg = src[src.index("namespace wg {"):src.index("}  // namespace wg")]
    assert int(re.search(r"constexpr int TILE = (\d+);", wg).group(1)) == SSD_TILE == launcher.TILE
    assert int(re.search(r"constexpr int MAX_Q = (\d+);", wg).group(1)) == launcher.MAX_WGMMA_Q
    assert re.search(r"const bool tf32 = route == (\d+);", src).group(1) == str(
        launcher.ROUTES["tf32x3"])
    assert "tf32x3" in ssd.launches_by_route


class _FakeSsdLib:
    """Stands in for the CUDA library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def repro_ssd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("case", [(4, 512, 80, 64, 64, 256), (1, 100, 3, 16, 8, 256)])
def test_ssd_tf32x3_launch_is_one_library_call(case, monkeypatch):
    """A launch is one call into the library with x, dt, a, b, c, the
    output, the fp32 state scratch (hi then lo) or none with one chunk, the
    shape, dtype code 0 and route code 2."""
    fake = _FakeSsdLib()
    monkeypatch.setattr(launcher, "_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    bsz, s, h, p, n, chunk = case
    q = min(chunk, s)
    x, dt, a, b, c = (torch.zeros(shape) for shape in
                      ((bsz, s, h, p), (bsz, s, h), (h,), (bsz, s, n), (bsz, s, n)))
    out = torch.empty_like(x)
    route = launcher.plan_for(x, b, c, q)
    assert route == "tf32x3"
    states = launcher.state_scratch(x, q, route)
    launcher.ssd_scan(x, dt, a, b, c, out, q, route, states)
    assert len(fake.calls) == 1
    (px, pdt, pa, pb, pc, pout, pst, cb, cs, ch, cp, cn, cq, dtype, rcode, dev,
     stream) = fake.calls[0]
    assert (px, pdt, pa, pb, pc, pout) == tuple(t.data_ptr() for t in (x, dt, a, b, c, out))
    assert pst == (None if states is None else states.data_ptr())
    assert (s // q > 1) == (states is not None)
    assert (cb, cs, ch, cp, cn, cq, dtype, rcode) == (bsz, s, h, p, n, q, 0, 2)
    assert (dev, stream) == (0, 0)


def ssd_f64(x, dt, a_log, b, c) -> torch.Tensor:
    """The scan's function in float64, step by step: h_t = exp(dt_t a) h_{t-1}
    + dt_t x_t b_t^T, y_t = h_t c_t (what the chunked scan computes exactly)."""
    x, dt, b, c = (t.double() for t in (x, dt, b, c))
    a = -torch.exp(a_log.double())
    bsz, s, h, p = x.shape
    state = torch.zeros((bsz, h, p, b.shape[-1]), dtype=torch.float64, device=x.device)
    ys = []
    for t in range(s):
        state = (state * torch.exp(dt[:, t] * a)[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], b[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, 1)


@cache
def _emulated(case, products=3, steep=False):
    arrays = (_steep if steep else _inputs)(case)
    return ssd_tf32x3(*_torch(arrays), case[-1], products=products), arrays


@pytest.mark.parametrize("case", TF32X3_CASES)
def test_ssd_tf32x3_matches_float64(case):
    out, arrays = _emulated(case)
    assert out.dtype == FP32 and tuple(out.shape) == case[:4]
    assert _err(out, ssd_f64(*_torch(arrays))) <= FP32_ACCURATE


@pytest.mark.parametrize("case", TF32X3_CASES)
def test_ssd_tf32x3_matches_port_chunked(case):
    out, arrays = _emulated(case)
    ref = ssd_chunked(*_torch(arrays), case[-1])
    assert _err(out, ref) <= FP32_ACCURATE
    torch.testing.assert_close(out, ref, atol=FP32_GATE, rtol=FP32_GATE)


@pytest.mark.parametrize("case", TF32X3_CASES)
def test_ssd_tf32x3_matches_jax_chunked(case, jx):
    out, arrays = _emulated(case)
    ref = jx.ssm.ssd_chunked(*(jx.jnp.asarray(a) for a in arrays), case[-1])
    assert _err(out, ref) <= FP32_ACCURATE


@pytest.mark.parametrize("case", TF32X3_CASES)
def test_ssd_tf32x3_matches_jax_pallas(case, jx):
    """The JAX package's Pallas ssd_scan, in interpret mode."""
    out, arrays = _emulated(case)
    pallas = jx.ssd(*(jx.jnp.asarray(a) for a in arrays), chunk=case[-1])
    assert _err(out, pallas) <= FP32_ACCURATE


@pytest.mark.parametrize("case", [(1, 512, 3, 64, 64, 256), (2, 300, 4, 24, 40, 100),
                                  (2, 128, 4, 32, 16, 32)])
def test_ssd_one_tf32_product_misses_fp32_and_three_meet_it(case):
    """One TF32 product a k8 (hi hi, the tensor cores' plain fp32 input)
    misses the fp32 gate against float64; the three products of the route
    meet 1e-5."""
    three, arrays = _emulated(case)
    one, _ = _emulated(case, products=1)
    ref = ssd_f64(*_torch(arrays))
    assert _err(one, ref) > FP32_GATE
    assert _err(three, ref) <= FP32_ACCURATE


@pytest.mark.parametrize("case", [(1, 256, 3, 64, 64, 128), (1, 200, 2, 64, 64, 256)])
def test_ssd_tf32x3_masks_before_exponent(case):
    """exp(dacum_i - dacum_j) above the diagonal is inf here; masked before
    the exponent the route stays finite and fp32-accurate."""
    out, arrays = _emulated(case, steep=True)
    d = np.cumsum(arrays[1][0, :64, 0] * -math.exp(3.0))
    assert d[0] - d[-1] > math.log(np.finfo(np.float32).max)  # unmasked, exp would overflow
    assert torch.isfinite(out).all()
    assert _err(out, ssd_f64(*_torch(arrays))) <= FP32_ACCURATE


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _on_card(arrays, dtype, chunk, device, route=None, shift=None):
    """One counted call on ``route`` (by default its planned one: bf16 wgmma,
    fp32 tf32x3) and the plain version on the same inputs; fp32 also within
    1e-5 of float64. ``shift``: which of x, b, c to store 4 bytes past a
    16-byte boundary."""
    x, dt, a_log, b, c = (t.to(device) for t in _torch(arrays, dtype))
    if shift is not None:
        held = {"x": x, "b": b, "c": c}
        t = held[shift]
        held[shift] = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)[1:].view(t.shape)
        held[shift].copy_(t)
        x, b, c = held["x"], held["b"], held["c"]
    route = route or ("wgmma" if dtype == BF16 else "tf32x3")
    assert launcher.plan_for(x, b, c, min(chunk, x.shape[1])) == route
    before, by_route = ssd.launches, dict(ssd.launches_by_route)
    out = ssd(x, dt, a_log, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert ssd.launches_by_route[route] == by_route[route] + 1
    if dtype == FP32:
        assert _err(out.cpu(), ssd_f64(x, dt, a_log, b, c).cpu()) <= FP32_ACCURATE
    return out.float().cpu(), ssd_ref(x, dt, a_log, b, c, chunk=chunk).float().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES + CHUNK_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_on_card(case, name, cuda_device):
    out, ref = _on_card(_inputs(case), getattr(torch, name), case[-1], cuda_device)
    assert _err(out, ref) <= (1e-5 if name == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ssd_kernel_masks_before_exponent_on_card(name, cuda_device):
    """Decays that overflow fp32 above the diagonal: both routes finite and
    within tolerance of the plain version."""
    case = (2, 512, 8, 64, 64, 256)
    out, ref = _on_card(_steep(case), getattr(torch, name), case[-1], cuda_device)
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= (1e-5 if name == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 512, 3, 64, 64, 256), (1, 256, 3, 64, 64, 128)])
def test_ssd_tf32x3_steep_on_card(case, cuda_device):
    """Steep decays at one more shape and a chunk of 128: finite, within 1e-5
    of the plain version and of float64."""
    out, ref = _on_card(_steep(case), FP32, case[-1], cuda_device)
    assert _err(out, ref) <= FP32_ACCURATE


@pytest.mark.cuda
@pytest.mark.parametrize("shift", ["x", "b", "c"])
def test_ssd_unaligned_operand_takes_simt_on_card(shift, cuda_device):
    """An fp32 operand 4 bytes off a 16-byte boundary cannot be read by TMA:
    the scan takes simt and still matches the plain version and float64."""
    case = (2, 256, 4, 64, 64, 128)
    out, ref = _on_card(_inputs(case), FP32, case[-1], cuda_device, route="simt", shift=shift)
    assert _err(out, ref) <= FP32_ACCURATE


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 256, 2, 64, 32, 64), (2, 300, 4, 24, 40, 100)])
def test_ssd_tf32x3_matches_emulation_on_card(case, cuda_device):
    """The kernel against the plain-torch walk of its arithmetic."""
    arrays = _inputs(case, seed=3)
    out, _ = _on_card(arrays, FP32, case[-1], cuda_device)
    assert _err(out, ssd_tf32x3(*_torch(arrays), case[-1])) <= FP32_ACCURATE


@pytest.mark.cuda
def test_ssd_tf32x3_is_deterministic_on_card(cuda_device):
    """No atomics: two calls are bit-equal."""
    x, dt, a_log, b, c = (t.to(cuda_device) for t in _torch(_inputs((2, 512, 8, 64, 64, 256))))
    assert torch.equal(ssd(x, dt, a_log, b, c, chunk=256), ssd(x, dt, a_log, b, c, chunk=256))
