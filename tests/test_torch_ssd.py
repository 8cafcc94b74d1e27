"""The port's SSD chunked scan (repro_torch.kernels.ssd and models.ssm)
against the JAX package's: ``ssd_chunked`` and the Pallas ``ops.ssd`` in
interpret mode, on the same numpy inputs. On the CPU the port's wrapper
takes its plain version, and ``emulate_ssd_wgmma`` walks the wgmma route's
tiling in plain torch; the CUDA kernels themselves are checked by the
``cuda``-marked cases. Tolerances: normalised max|d|/max|ref| at 1e-5 in
fp32 (tests/test_kernels.py::test_ssd_matches_chunked_ref), 2e-2 in bf16."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ops import ssd as jax_ssd  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels.ssd import ssd as launcher  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import _segsum, ssd_chunked, ssd_ref  # noqa: E402
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
BF16 = torch.bfloat16


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
def test_wgmma_tiling_exact_matches_reference(case):
    """With every value kept fp32, the emulated tiling is the reference's
    function: the port's ssd_chunked and JAX's at 1e-5."""
    arrays = _inputs(case, seed=5)
    chunk = case[-1]
    out = emulate_ssd_wgmma(*_torch(arrays), chunk, rounded=False)
    assert tuple(out.shape) == case[:4]
    assert _err(out, ssd_chunked(*_torch(arrays), chunk)) <= 1e-5
    assert _err(out, jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk)) <= 1e-5


@pytest.mark.parametrize("case", TILING_CASES)
def test_wgmma_tiling_rounded_matches_reference(case):
    """With the route's bf16 rounding points (G, the update's B rows, the
    state copy) on bf16 x, b, c: within 2e-2 of the port's ssd_chunked and of
    JAX's compiled ssd_chunked on the same inputs."""
    arrays = _inputs(case, seed=6)
    chunk = case[-1]
    tx = _torch(arrays, BF16)
    out = emulate_ssd_wgmma(*tx, chunk)
    assert out.dtype == BF16
    assert _err(out.float(), ssd_chunked(*tx, chunk).float()) <= 2e-2
    x, dt, a_log, b, c = (jnp.asarray(a) for a in arrays)
    ref = jax.jit(jax_ssm.ssd_chunked, static_argnums=5)(
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
    """bf16 that TMA can read takes wgmma; fp32, P or N not a multiple of 8
    or above 64, a chunk past MAX_WGMMA_Q and unaligned storage take simt."""
    plan = launcher.plan
    assert plan(64, 64, 256, BF16, True) == "wgmma"  # Zamba2-2.7B
    assert plan(24, 40, 100, BF16, True) == "wgmma"
    assert plan(8, 8, 1, BF16, True) == "wgmma"
    assert plan(64, 64, launcher.MAX_WGMMA_Q, BF16, True) == "wgmma"
    for args in [(64, 64, 256, torch.float32, True), (64, 64, 256, BF16, False),
                 (20, 64, 256, BF16, True), (64, 12, 256, BF16, True), (72, 64, 256, BF16, True),
                 (64, 64, launcher.MAX_WGMMA_Q + 1, BF16, True)]:
        assert plan(*args) == "simt", args
    x = torch.zeros((2, 512, 3, 64), dtype=BF16)
    assert tuple(launcher.state_scratch(x, 128).shape) == (2, 3, 3, 64, 64)
    assert launcher.state_scratch(x, 512) is None


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


def _on_card(arrays, dtype, chunk, device):
    """One counted call on its planned route (bf16 wgmma, fp32 simt) and the
    plain version on the same inputs."""
    x, dt, a_log, b, c = (t.to(device) for t in _torch(arrays, dtype))
    route = "wgmma" if dtype == BF16 else "simt"
    assert launcher.plan_for(x, b, c, min(chunk, x.shape[1])) == route
    before, by_route = ssd.launches, dict(ssd.launches_by_route)
    out = ssd(x, dt, a_log, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert ssd.launches_by_route[route] == by_route[route] + 1
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
