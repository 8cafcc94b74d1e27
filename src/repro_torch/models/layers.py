"""Building blocks of the dense LM (pure functions, explicit params).

The counterpart of ``repro/models/layers.py``, function for function, with
the same cast points: weights are cast to the compute dtype at each
product, norms and RoPE compute in fp32 and cast back, and the plain
attention takes fp32 scores and casts the probabilities to the compute
dtype before the PV product. Params are nested dicts of tensors.

``use_kernel=True`` routes each dense product through the hand-written
matmul kernel (``repro_torch.kernels.matmul``) and each RMSNorm through the
RMSNorm kernel; ``use_kernel=False`` takes their plain versions, the oracle
of tests and the smoke run. Attention takes the kernel through the
``attn_fn`` hook, as in the JAX package.

On a mesh (``train.steps.build_step(mesh=)``) the params and activations
are DTensors: ``constrain`` pins the activations at the reference's points,
each product reads its weight ``gathered`` over the FSDP axes and has its
partial sums ``summed``, and the kernels run on each rank's local shards
(``*_on_shards``). With no
activation table installed, ``constrain`` returns its input and nothing
here changes.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.decode_attention.ops import decode_attend, rope_append
from repro_torch.kernels.matmul.ops import matmul, matmul_on_shards
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_on_shards
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.obs import hotpath
from repro_torch.parallel.act import (batch_heads_spec, constrain, fitted_placements, gathered,
                                      local_apply, pinned, summed)

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _randn(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(device)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype=torch.float32, *,
               device="cpu") -> torch.Tensor:
    return (_randn(generator, (d_in, d_out), device) * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype=torch.float32, *,
               device="cpu") -> torch.Tensor:
    return (_randn(generator, (vocab, d), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Products and norms: the kernel or its plain version
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N), w cast to x's dtype, fp32 sums.

    On a mesh, w is gathered over the FSDP axes before the cast, as XLA
    gathers the reference's fp32 weights; where K is split over a mesh
    axis (a row-parallel product) each rank's partial product stays fp32
    until the parts are summed, so the result is rounded once, as on one
    card."""
    w = gathered(w).to(x.dtype).contiguous()
    if isinstance(x, DTensor):
        x = _rows_whole(x)
    x2 = x.reshape(-1, x.shape[-1])
    if not isinstance(x2, DTensor):
        y = matmul(x2, w) if use_kernel else matmul_ref(x2, w)
        return y.reshape(*x.shape[:-1], w.shape[1])
    split_k = any(px == Shard(1) and pw == Shard(0) for px, pw in zip(x2.placements, w.placements))
    out_dtype = torch.float32 if split_k else None
    y = (matmul_on_shards(x2, w, out_dtype=out_dtype) if use_kernel
         else matmul_ref(x2, w, out_dtype=out_dtype))
    return pinned(summed(y).to(x.dtype).reshape(*x.shape[:-1], w.shape[1]))


def _rows_whole(x: DTensor) -> DTensor:
    """``x`` gathered along every split dim but the batch (dim 0) and the
    contracted last one: a sequence-parallel activation meets a product
    whole (Megatron's all-gather before the column-parallel product), and
    flattening the rows then keeps a plain split of the batch."""
    inner = [p.is_shard() and p.dim not in (0, x.ndim - 1) for p in x.placements]
    if not any(inner):
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if i else p
                                               for i, p in zip(inner, x.placements)))


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """``table[tokens]`` in ``dtype``; on a mesh, the gather of the table
    ``gathered`` over the FSDP axes (DTensor's embedding op)."""
    if isinstance(table, DTensor):
        return F.embedding(tokens, gathered(table)).to(dtype)
    return table[tokens].to(dtype)


def split_last(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``t`` with its last dim split into ``sizes`` (heads, head dim). A
    DTensor whose last dim is split over mesh axes that do not divide the
    first of ``sizes`` (24 heads over a 16-way ``model`` axis) first gathers
    those axes: a split that cuts a head cannot become a split of heads.
    The result's gradient takes its forward placements (``act.pinned``)."""
    if isinstance(t, DTensor):
        last, mesh = t.ndim - 1, t.device_mesh
        ways = math.prod(mesh.size(i) for i, p in enumerate(t.placements) if p.is_shard(last))
        if sizes[0] % ways:
            t = t.redistribute(mesh, tuple(Replicate() if p.is_shard(last) else p
                                           for p in t.placements))
    return pinned(t.reshape(*t.shape[:-1], *sizes))


def init_rmsnorm(d: int, dtype=torch.float32, *, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, params, eps: float = 1e-6, *, use_kernel: bool = False):
    if use_kernel:
        fn = rmsnorm_on_shards if isinstance(x, DTensor) else rmsnorm
        return fn(x, params["scale"], eps=eps)
    return rmsnorm_ref(x, params["scale"], eps)


def init_layernorm(d: int, dtype=torch.float32, *, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(x: torch.Tensor, params, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias in fp32, cast back to x's
    dtype; the variance is the mean of squared deviations, as the reference
    takes it. No Pallas kernel of the reference computes it."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, *, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions.float()[..., None] * freqs  # (..., S, hd/2)
    if ang.dim() == 2:  # (S, hd/2) -> broadcast over batch
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window)
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int | None = None, dtype=torch.float32, *, device="cpu"):
    hd = head_dim or d_model // n_heads
    return {
        "wq": dense_init(generator, d_model, n_heads * hd, dtype, device=device),
        "wk": dense_init(generator, d_model, n_kv * hd, dtype, device=device),
        "wv": dense_init(generator, d_model, n_kv * hd, dtype, device=device),
        "wo": dense_init(generator, n_heads * hd, d_model, dtype, device=device),
    }


def _causal_mask(s_q: int, s_k: int, window: int | None = None, offset: int = 0, *,
                 device="cpu") -> torch.Tensor:
    """(s_q, s_k) additive mask. ``offset`` = start position of the queries
    within the key timeline (for decode: offset = s_k - s_q)."""
    qi = torch.arange(s_q, device=device)[:, None] + offset
    kj = torch.arange(s_k, device=device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > qi - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, float("-inf"))


def gqa_attention(x, params, n_heads: int, n_kv: int, *, rope: bool = True,
                  rope_theta: float = 10000.0, window: int | None = None,
                  causal: bool = True, positions=None, kv_override=None, attn_fn=None,
                  use_kernel: bool = False):
    """Full-sequence GQA self attention (prefill path).

    ``kv_override`` supplies external (k, v) for cross attention.
    ``attn_fn`` optionally replaces the core softmax(QK^T)V computation
    (e.g. with ``repro_torch.kernels.flash_attention.ops.attn_fn``).
    """
    b, s, d = x.shape
    hd = params["wq"].shape[1] // n_heads

    q = constrain(split_last(linear(x, params["wq"], use_kernel), n_heads, hd), "heads")
    if kv_override is None:
        k = split_last(linear(x, params["wk"], use_kernel), n_kv, hd)
        v = split_last(linear(x, params["wv"], use_kernel), n_kv, hd)
    else:
        k, v = kv_override

    if rope:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        if kv_override is None:
            k = apply_rope(k, pos, rope_theta)

    if attn_fn is not None:
        out = attn_fn(q, k, v, causal=causal, window=window)
    elif isinstance(q, DTensor):
        out = _attend_on_shards(q, k, v, causal, window)
    else:
        out = _attend(q, k, v, causal, window)
    return linear(constrain(out.reshape(b, s, -1), "attn_out"), params["wo"], use_kernel)


def _attend(q, k, v, causal: bool, window):
    """The plain attention: q (B, S, H, hd), k, v (B, Sk, KV, hd) -> (B, S,
    H*hd); fp32 scores, the probabilities cast to q's dtype before PV."""
    b, s, n_heads, hd = q.shape
    s_k, n_kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, n_kv, n_heads // n_kv, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    if causal:
        scores = scores + _causal_mask(s, s_k, window, offset=s_k - s,
                                       device=q.device)[None, None, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bngst,btnh->bsngh", probs, v).reshape(b, s, n_heads * hd)


def _attend_on_shards(q, k, v, causal: bool, window):
    """``_attend`` of DTensors on each rank's local shards: the batch split
    over the data axes and the heads over ``model`` where both H and KV
    divide (a rank's query heads then meet their own KV groups), else
    whole heads. Its einsums flatten (B, KV) into one batch dim, which
    DTensor cannot do in either pass while both are split."""
    mesh = q.device_mesh
    pq = fitted_placements(batch_heads_spec(mesh, 4, 2), q)
    pk = fitted_placements(batch_heads_spec(mesh, 4, 2), k)
    if pq != pk:
        pq = fitted_placements(batch_heads_spec(mesh, 4), q)
        pk = fitted_placements(batch_heads_spec(mesh, 4), k)
    return local_apply(functools.partial(_attend, causal=causal, window=window), (q, k, v),
                       (pq, pk, pk), pq)


def _whole_heads(t):
    """A DTensor with every placement but its batch split made ``Replicate``:
    decode's one token of q, k and v, small beside the sequence-sharded
    cache they meet (the attention's einsums flatten (B, KV) into one batch
    dim, which DTensor refuses (torch 2.11) while both are split)."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh,
                          tuple(p if p == Shard(0) else Replicate() for p in t.placements))


def gqa_decode_attention(x, params, n_heads: int, n_kv: int, k_cache, v_cache, write_pos, *,
                         rope_pos=None, valid_upto=None, rope: bool = True,
                         rope_theta: float = 10000.0, use_kernel: bool = False,
                         donate: bool = False):
    """One-token decode: x (B, 1, D); caches (B, S_slots, n_kv, hd).

    ``write_pos`` (B,) — cache slot the new KV is written to (for a
    sliding-window ring buffer this is ``pos % slots``).
    ``rope_pos`` (B,) — absolute position for RoPE (defaults to write_pos).
    ``valid_upto`` (B,) — highest valid slot index (defaults to write_pos;
    a full ring buffer passes slots-1 so every slot participates).
    Returns (out, new_k_cache, new_v_cache); the caches passed in are not
    changed. The attention over the cache is plain PyTorch, as in the JAX
    package, where it runs outside any kernel. While a profiler records, the
    cache write is the span ``attn.cache_write`` and the attention over the
    cache ``attn.cache_read`` (``obs.hotpath.span``).

    ``donate=True`` takes the decode-attention kernels on caches they take
    (``kernels.decode_attention.ops.takes``; int64 positions): the new K/V
    is written into ``k_cache`` and ``v_cache`` in place
    (``rope_append``, inside ``attn.cache_write``) and the attention reads
    each slot's valid positions only (``decode_attend``, inside
    ``attn.cache_read``); it returns the caches passed in.
    """
    b, one, d = x.shape
    hd = params["wq"].shape[1] // n_heads
    cd = x.dtype
    s_slots = k_cache.shape[1]
    rope_pos = write_pos if rope_pos is None else rope_pos
    valid_upto = write_pos if valid_upto is None else valid_upto
    if donate:
        q, k, v = (linear(x, params[w], use_kernel) for w in ("wq", "wk", "wv"))
        with hotpath.span("attn.cache_write"):
            q = rope_append(q, k, v, k_cache, v_cache, write_pos, rope_pos,
                            rope_theta if rope else None)
        with hotpath.span("attn.cache_read"):
            out = decode_attend(q, k_cache, v_cache, valid_upto)
        return linear(out, params["wo"], use_kernel), k_cache, v_cache

    q = split_last(linear(x, params["wq"], use_kernel), n_heads, hd)
    k = split_last(linear(x, params["wk"], use_kernel), n_kv, hd)
    v = split_last(linear(x, params["wv"], use_kernel), n_kv, hd)
    if rope:
        q = apply_rope(q, rope_pos[:, None], rope_theta)
        k = apply_rope(k, rope_pos[:, None], rope_theta)
    q, k, v = _whole_heads(q), _whole_heads(k), _whole_heads(v)

    # Write new kv at write_pos (one-hot blend, as the reference keeps shapes
    # static). Built by comparison, as jax.nn.one_hot is: a position outside
    # [0, S_slots) gives an all-zero row, so that write is dropped; no
    # scatter, so the step can be captured in a CUDA graph.
    with hotpath.span("attn.cache_write"):
        slots = torch.arange(s_slots, device=write_pos.device)
        onehot = (slots[None] == write_pos[:, None]).to(cd)  # (B, S_slots)
        k_cache = k_cache * (1 - onehot)[..., None, None] + onehot[..., None, None] * k
        v_cache = v_cache * (1 - onehot)[..., None, None] + onehot[..., None, None] * v

    g = n_heads // n_kv
    qg = q.reshape(b, n_kv, g, hd)
    with hotpath.span("attn.cache_read"):
        # einsum takes one dtype; promote as jnp.einsum does for a cache in another one
        dk, dv = torch.promote_types(cd, k_cache.dtype), torch.promote_types(cd, v_cache.dtype)
        scores = torch.einsum("bngh,btnh->bngt", qg.to(dk), k_cache.to(dk)).float()
        scores = scores * (1.0 / math.sqrt(hd))
        t = torch.arange(s_slots, device=x.device)[None, None, None, :]
        ok = t <= valid_upto[:, None, None, None]
        scores = scores.masked_fill(~ok, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(cd)
        if isinstance(probs, DTensor):  # a sequence-sharded cache: its parts summed in fp32
            out = summed(torch.einsum("bngt,btnh->bngh", probs.to(dv).float(),
                                      v_cache.to(dv).float())).to(dv)
        else:
            out = torch.einsum("bngt,btnh->bngh", probs.to(dv), v_cache.to(dv))
    out = out.reshape(b, 1, n_heads * hd)
    return linear(out, params["wo"], use_kernel), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype=torch.float32, *, device="cpu"):
    p = {"w_up": dense_init(generator, d_model, d_ff, dtype, device=device),
         "w_down": dense_init(generator, d_ff, d_model, dtype, device=device)}
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype, device=device)
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s formula, x * (1 / (1 + exp(-x))), each step rounded
    to x's dtype as the JAX package rounds it (``F.silu`` rounds once, which
    in bf16 differs in about a third of the elements)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s formula, logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)), from elementwise ops that DTensor has rules for."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def mlp(x, params, activation: str = "silu", *, use_kernel: bool = False):
    h = constrain(linear(x, params["w_up"], use_kernel), "ffn")
    if activation == "relu2":        # Nemotron squared ReLU
        h = torch.square(torch.relu(h))
    elif activation == "gelu":       # jax.nn.gelu's default is the tanh form
        h = F.gelu(h, approximate="tanh")
    else:
        h = silu(h)
    if "w_gate" in params:
        h = h * linear(x, params["w_gate"], use_kernel)
    return linear(h, params["w_down"], use_kernel)
