"""Plain PyTorch building blocks of the reference models, in float32.

Nothing here imports the program under test. Every block takes one
sequence (S, ...) in float32 and reads the weights as the benchmark made
them (bfloat16), widened to float32 where they are used. ``precision``
selects the arithmetic of the dense products: ``"fp32"`` is the reference
itself; ``"fp8"`` is the control, the same model with both operands of
every dense product rounded to float8 e4m3 with a scale a tensor (the
recipe of per-tensor fp8 training and serving), the step below the configuration's
bfloat16 that a later change could be tempted to take.
"""
from __future__ import annotations

import contextlib
import math

import torch

PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


@contextlib.contextmanager
def full_fp32():
    """float32 products in float32: TF32 off in cuBLAS and cuDNN while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), returned in float32."""
    amax = t.abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (S, K) float32 @ w (K, N) -> (S, N) float32."""
    w = w.float()
    if precision == "fp8":
        x, w = to_fp8(x), to_fp8(w)
    elif precision != "fp32":
        raise ValueError(f"precision must be one of {PRECISIONS}; got {precision!r}")
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


ACTIVATIONS = {"gelu": gelu_tanh, "silu": silu}


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, H, hd) at positions 0..S-1: the two halves of
    each head rotated as pairs (x_i, x_{i + hd/2}), frequency theta^(-2i/hd)."""
    s, _, hd = x.shape
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rows: int = 1024, window: int | None = None) -> torch.Tensor:
    """Softmax attention of q (S, H, hd) over k, v (S, KV, hd), each query
    seeing keys 0..its own position, and with a sliding ``window`` only the
    last ``window`` of them; query head h reads KV head h // (H / KV).
    Queries in blocks of ``rows``. Returns (S, H * hd)."""
    s, h, hd = q.shape
    kv = k.shape[1]
    k = k.repeat_interleave(h // kv, dim=1).transpose(0, 1)  # (H, S, hd)
    v = v.repeat_interleave(h // kv, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        qb = q[r0:r1].transpose(0, 1)                          # (H, R, hd)
        scores = qb @ k[:, :r1].transpose(1, 2) / math.sqrt(hd)  # (H, R, r1)
        pos = torch.arange(r0, r1, device=q.device)[:, None]
        key = torch.arange(r1, device=q.device)[None]
        hidden = key > pos
        if window is not None:
            hidden |= key <= pos - window
        scores = scores.masked_fill(hidden, float("-inf"))
        out[r0:r1] = (torch.softmax(scores, dim=-1) @ v[:, :r1]).transpose(0, 1)
    return out.reshape(s, h * hd)


def normal_(shape, std: float, gen: torch.Generator, dtype) -> torch.Tensor:
    """N(0, std²) drawn in ``dtype`` on the generator's device in one call."""
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype).mul_(std)


def uniform_(shape, lo: float, hi: float, gen: torch.Generator) -> torch.Tensor:
    """U(lo, hi) in float32 on the generator's device in one call."""
    return torch.rand(shape, generator=gen, device=gen.device).mul_(hi - lo).add_(lo)
