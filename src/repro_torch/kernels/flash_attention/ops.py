"""Checked entry points of the flash-attention kernel.

The counterparts of ``repro/kernels/flash_attention/ops.py``:
``flash_attention`` takes the model-native q (B, S, H, hd) and k, v
(B, Sk, KV, hd); ``attn_fn`` has the signature of the hook of
``repro_torch.models.layers.gqa_attention`` and returns (B, S, H*hd). The
causal mask aligns the queries to the end of the key timeline (offset
Sk - S), as ``attention_ref`` does; the Pallas kernel starts them at 0,
which is the same when S = Sk. A CUDA tensor launches the CUDA kernel (or
raises) on the route ``flash_attention.plan_for`` picks; a CPU tensor takes
the plain version ``attention_ref``. ``flash_attention.launches`` counts
kernel launches, one per call, and ``flash_attention.launches_by_route``
splits them by route (``wgmma``, ``tf32x3``, ``simt``).
A fake tensor (the dry run's) takes the op's fake implementation
(``is_fake``): nothing launches, and the op's FLOP formula counts
4·B·H·S·Sk·hd, the full square of scores, as the plain attention's two
products count it (the kernel skips the masked blocks). It raises when
autograd would record the call (``refuse_grad``): the
kernel has no backward, and training takes the plain route. It raises on a
DTensor (``refuse_dtensor``): ``flash_attention_on_shards`` takes DTensors,
through the op ``repro_torch::flash_attention``, whose sharding strategies
DTensor reads, so that each rank's kernel runs on its local batch rows and
heads; ``attn_fn`` takes either.
While a profiler records, a call is the span ``kernels.flash_attention``
(``repro_torch.obs.hotpath``), from the checks through the launch.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import is_fake, refuse_dtensor, refuse_grad
from repro_torch.obs import hotpath
from .flash_attention import DTYPE_CODES, ROUTES, launch, plan_for
from .ref import attention_ref

_MAX_HD = 256        # the kernel's widest head (shared-memory tiles of 64 rows)
_MAX_GRID_Y = 65535  # CUDA's limit on grid y (B * H)


def _check(q, k, v, window) -> None:
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes three tensors")
    refuse_dtensor("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, S, H, hd) and k, v (B, Sk, KV, hd); "
                         f"got shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)} differ in batch or "
                         f"head dim, or H is not a multiple of KV")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16, one for q, k and v; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device) or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention takes q, k, v on one CPU or CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention takes non-empty tensors")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    if hd > _MAX_HD or b * h > _MAX_GRID_Y:
        raise ValueError(f"head dim {hd} or B*H {b * h} exceeds the kernel's limits "
                         f"({_MAX_HD}, {_MAX_GRID_Y})")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or positive; got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, Sk, KV, hd) -> (B, S, H, hd)."""
    if hotpath.recording():
        with hotpath.span("kernels.flash_attention"):
            return _flash_attention(q, k, v, causal, window)
    return _flash_attention(q, k, v, causal, window)


def _flash_attention(q, k, v, causal, window):
    _check(q, k, v, window)
    refuse_grad("flash_attention", q, k, v)
    if is_fake(q, k, v):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    out = torch.empty_like(q)
    route = plan_for(q, k, v)
    launch(q, k, v, out, route, torch.cuda.current_stream(q.device).cuda_stream, causal=causal,
           window=window)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)


def attn_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
            window: int | None = None) -> torch.Tensor:
    """Adapter matching gqa_attention's ``attn_fn`` hook: returns (B, S, H*hd)."""
    b, s, h, hd = q.shape
    fn = flash_attention_on_shards if isinstance(q, DTensor) else flash_attention
    return fn(q, k, v, causal=causal, window=window).reshape(b, s, h * hd)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int | None) -> torch.Tensor:
    # contiguous, as the fake implementation says (the plain version's need not be)
    return flash_attention(q, k, v, causal=causal, window=window).contiguous()


@_flash_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """4·B·H·S·Sk·hd: QKᵀ and PV over every (query, key) pair."""
    b, s, h, hd = q_shape
    return 4 * b * h * s * k_shape[1] * hd


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _flash_strategies(q, k, v, causal, window):
    """Per mesh dim: q, k and v split alike over the batch, or over the heads
    (dim 2) when every mesh dim's size divides the KV heads, so that each
    rank's query heads meet their own KV groups; or all replicated."""
    out = [([Shard(0)], [Shard(0), Shard(0), Shard(0), None, None]),
           ([Replicate()], [Replicate(), Replicate(), Replicate(), None, None])]
    if all(k.shape[2] % n == 0 for n in q.mesh.shape):
        out.append(([Shard(2)], [Shard(2), Shard(2), Shard(2), None, None]))
    return out


def flash_attention_on_shards(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """``flash_attention`` of DTensors of one mesh: each rank's kernel on its
    local batch rows and heads (one launch a rank, counted in
    ``flash_attention.launches``)."""
    refuse_grad("flash_attention", q, k, v)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window)
