"""Mixture-of-Experts decoder (llama4-maverick, kimi-k2): the dense dispatch
on one card, and expert parallelism over the ranks of a mesh axis.

The counterpart of ``repro/models/moe.py``. Dispatch is the reference's
scatter/gather, step for step: the router's softmax in fp32; the top-k by
a stable descending sort, so that tied probabilities give the lower expert
first as ``jax.lax.top_k`` does; gates renormalised over the k; each
assignment's slot within its expert from the k-major flattening and a
stable argsort (first choices take slots before second choices); a
capacity of ``ceil(T k cf / E)``, at least 4; an assignment over capacity
is dropped, its slot clipped to the last one and its token scaled to zero,
so the scatter-add (``index_add_``) adds zeros onto a live slot. The
load-balance aux loss counts dropped assignments too.

With ``use_kernel=True`` the expert products run through the matmul
kernel one expert at a time (3 launches an expert: up, gate, down, at M =
capacity), and the router, attention, shared expert and head through
``linear`` and the flash and RMSNorm kernels as in the dense LM;
``use_kernel=False`` runs the expert products as batched ``einsum``s, as
the reference does.

Expert parallelism (``_moe_mlp_ep``, the reference's
``_moe_mlp_ep_shardmap``): when the installed activation specs name an
``_ep_mesh`` (``parallel.act.ep_mesh``), ``moe_mlp`` runs the router and
top-k replicated on every rank of the mesh axis, each rank dispatches the
tokens to its own ``n_experts / ep`` experts only (its expert leaves hold
just those; ``init_moe_mlp(experts=...)`` draws them) with the capacity of
the global token count, and the partial outputs are all-reduced in fp32;
the shared expert is added after the reduction. It differentiates: the
all-reduces of y and of the aux terms pass the cotangent through unchanged
(every rank holds the replicated loss), and the replicated input and
router enter the expert region through an identity whose backward sums
their cotangents over the expert axis (the transpose of a replicated input
to the reference's ``shard_map``), so each rank's expert leaves take their
own gradients and the router and input take the whole layer's.

On a DTensor mesh (``train.steps.build_step(mesh=)``) ``moe_mlp`` runs
``_moe_mlp_mesh``: the same dispatch over the global tokens, its tokens
split over the data axes and its experts over ``model`` (where the experts
divide; the reference's ``experts`` spec), each rank computing on its
local shards. The slots are the global ones: the assignments each data
rank counts per (choice, expert) are all-gathered, and each assignment's
slot is the choices before it, the data ranks before it and its place
among this rank's tokens, as the global k-major order gives it. Each rank
writes its kept tokens into the buffers of its experts at those slots, the
buffers are reduce-scattered over the data axes along the slots (every
slot filled by one token, so the sum is exact), each rank runs its experts
on its share of the slots, the outputs are all-gathered back, and each
rank gathers its tokens' outputs from its experts; the parts are summed
over ``model`` in fp32. An ``_ep_mesh`` names the same layout there (``_moe_mlp_ep``).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import attn_fn as flash_attn_fn
from repro_torch.parallel.act import constrain, ep_mesh, fitted_placements, gathered
from repro_torch.parallel.sharding import dp_spec
from repro_torch.parallel.collectives import all_reduce, axis_group
from .layers import (_randn, dense_init, embed, embed_init, gqa_attention, gqa_decode_attention,
                     init_attention, init_mlp, init_rmsnorm, linear, mlp, rms_norm, silu)
from .transformer import _device, _stack, layer, rematted, softmax_xent, unstack


def init_moe_mlp(generator: torch.Generator, cfg: ArchConfig, dtype=torch.float32, *,
                 device="cpu", experts: tuple[int, int] | None = None):
    """Random weights from ``generator`` at the JAX initialisers' scales. The
    expert leaves are drawn one expert at a time in fp32 and stored in
    ``dtype``, so no whole leaf is ever held in fp32.

    ``experts=(lo, hi)`` keeps only experts lo..hi-1 of each expert leaf (an
    expert-parallel rank's share). Every expert is still drawn, in the same
    order, so the generator moves as for the whole layer and the kept
    experts, the router and the shared expert equal the whole layer's."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    lo, hi = experts or (0, e.n_experts)

    def experts_leaf(a, b):
        w = torch.empty((hi - lo, a, b), dtype=dtype, device=device)
        for i in range(e.n_experts):
            draw = _randn(generator, (a, b), device) * (1.0 / math.sqrt(a))
            if lo <= i < hi:
                w[i - lo] = draw
        return w

    p = {"router": dense_init(generator, d, e.n_experts, dtype, device=device),
         "w_up": experts_leaf(d, f), "w_gate": experts_leaf(d, f),
         "w_down": experts_leaf(f, d)}
    if e.n_shared:
        p["shared"] = init_mlp(generator, d, e.n_shared * f, True, dtype, device=device)
    return p


def route(xf: torch.Tensor, router: torch.Tensor, cfg: ArchConfig, *, use_kernel: bool = False):
    """xf (T, d) -> (router logits (T, E) fp32, probabilities, renormalised
    gates (T, k) fp32, experts (T, k)), the k experts in descending
    probability, ties to the lower index."""
    logits = linear(xf, router, use_kernel).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :cfg.moe.top_k], idx[:, :cfg.moe.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate_vals, expert_idx


def capacity(t: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``t`` tokens."""
    e = cfg.moe
    return max(int(math.ceil(t * e.top_k * e.capacity_factor / e.n_experts)), 4)


def _slots(expert_idx: torch.Tensor, n_local: int, e_offset: int, cap: int, offsets=None):
    """The slots of the k*T assignments, k-major (all first choices, then all
    second ones), in the ``n_local`` experts e_offset..: (flat local experts,
    clipped to the range; slots, clipped to ``cap``; kept mask; assignments
    per local expert, dropped ones included). An assignment's slot is the
    number of assignments to its expert before it in the k-major order:
    those of the earlier choices (the offset of its (choice, expert)) and
    those of its own choice before it. ``offsets`` maps the (k, n_local)
    counts per (choice, expert) to those offsets (the mesh's global ones);
    by default they are the counts of the earlier choices. An assignment to
    an expert out of the range sorts after every local one, takes no slot
    and is not kept."""
    t, k = expert_idx.shape
    flat_e = expert_idx.t().reshape(-1) - e_offset                    # (k*T,)
    in_range = (flat_e >= 0) & (flat_e < n_local)
    flat_e = torch.clamp(flat_e, 0, n_local - 1)
    key = torch.arange(k, device=flat_e.device).repeat_interleave(t) * n_local + flat_e
    # a scatter, not bincount: bincount on a CUDA tensor waits for the device
    count = torch.zeros(k * n_local, dtype=key.dtype, device=key.device).scatter_add_(
        0, key, in_range.to(key.dtype))
    order = torch.argsort(torch.where(in_range, key, k * n_local), stable=True)
    starts = torch.cumsum(count, 0) - count
    within = torch.empty_like(key)
    within[order] = torch.arange(key.shape[0], device=key.device) - starts[key[order]]
    count = count.reshape(k, n_local)
    before = torch.cumsum(count, 0) - count if offsets is None else offsets(count)
    slot = before.reshape(-1)[key] + within
    keep = in_range & (slot < cap)
    return flat_e, torch.clamp(slot, 0, cap - 1), keep, count.sum(0)


def dispatch(expert_idx: torch.Tensor, cfg: ArchConfig):
    """The dense dispatch's slots: (flat experts, slots clipped to the
    capacity, kept mask, assignments per expert (dropped ones included),
    capacity)."""
    cap = capacity(expert_idx.shape[0], cfg)
    return (*_slots(expert_idx, cfg.moe.n_experts, 0, cap), cap)


def _experts(buffers: torch.Tensor, p, use_kernel: bool) -> torch.Tensor:
    """(E, C, d) token buffers -> (E, C, d): each expert's gated MLP."""
    cd = buffers.dtype
    if not use_kernel:
        up = torch.einsum("ecd,edf->ecf", buffers, p["w_up"].to(cd))
        gate = torch.einsum("ecd,edf->ecf", buffers, p["w_gate"].to(cd))
        return torch.einsum("ecf,efd->ecd", silu(up) * gate, p["w_down"].to(cd))
    outs = []
    for e in range(buffers.shape[0]):
        h = silu(linear(buffers[e], p["w_up"][e], True)) * linear(buffers[e], p["w_gate"][e], True)
        outs.append(linear(h, p["w_down"][e], True))
    return torch.stack(outs)


def moe_mlp(x: torch.Tensor, p, cfg: ArchConfig, *, use_kernel: bool = False):
    """x (B, S, d) -> (y (B, S, d), aux loss, dropped assignments (a 0-d
    tensor, so that no call waits for the device)). Expert-parallel when the
    installed activation specs name an ``_ep_mesh``."""
    mesh_axis = ep_mesh()
    if mesh_axis is not None:
        return _moe_mlp_ep(x, p, cfg, *mesh_axis, use_kernel=use_kernel)
    if isinstance(x, DTensor):
        return _moe_mlp_mesh(x, p, cfg, use_kernel=use_kernel)
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    _, probs, gate_vals, expert_idx = route(xf, p["router"], cfg, use_kernel=use_kernel)
    y, counts, keep = _expert_compute(xf, p, cfg, e.n_experts, 0, gate_vals, expert_idx,
                                      capacity(t, cfg), use_kernel=use_kernel)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    aux = e.n_experts * torch.sum(probs.mean(0) * counts.float()) / (t * e.top_k)
    if "shared" in p:
        y = y + mlp(xf, p["shared"], "silu", use_kernel=use_kernel)
    return y.reshape(b, s, d), aux, (~keep).sum()


def _expert_compute(xf: torch.Tensor, p, cfg: ArchConfig, n_local: int, e_offset: int,
                    gate_vals: torch.Tensor, expert_idx: torch.Tensor, capacity: int, *,
                    use_kernel: bool = False, offsets=None, on_slots=None):
    """Dispatch xf (T, d) to the ``n_local`` experts e_offset.. of ``p``'s
    expert leaves, run them and combine -> (y (T, d), assignments per local
    expert (dropped ones included), kept mask (k*T,)). An assignment to
    another rank's expert is out of range: it sorts after every local one,
    takes no slot and adds nothing. A DTensor mesh's dispatch
    (``_moe_mlp_mesh``) gives the slots' ``offsets`` (``_slots``) and
    ``on_slots``, which takes the filled (n_local, capacity, d) buffers to
    the experts and their outputs back, in place of the table's
    constraints."""
    pin = constrain if on_slots is None else (lambda t, name: t)
    k = cfg.moe.top_k
    t, d = xf.shape
    cd = xf.dtype
    flat_e, slot, keep, counts = _slots(expert_idx, n_local, e_offset, capacity, offsets)
    buf_idx = flat_e * capacity + slot                                # (k*T,)

    xk = pin(xf.repeat(k, 1) * keep[:, None].to(cd), "tokens_flat")
    buffers = torch.zeros((n_local * capacity, d), dtype=cd, device=xf.device)
    buffers = pin(buffers.index_add_(0, buf_idx, xk), "experts_flat")
    buffers = buffers.reshape(n_local, capacity, d)
    if on_slots is None:
        out = constrain(_experts(constrain(buffers, "experts"), p, use_kernel), "experts")
    else:
        out = on_slots(buffers)
    out = pin(out.reshape(-1, d), "experts_flat")
    gates = keep.to(cd) * gate_vals.t().reshape(-1).to(cd)
    y = pin(out[buf_idx] * gates[:, None], "tokens_flat")
    return y.reshape(k, t, d).sum(0), counts, keep


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``group``: a
    replicated tensor entering per-rank work whose results are summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Summed(torch.autograd.Function):
    """All-reduce (sum) forward; the backward passes the cotangent through:
    the sum is replicated, and so is the loss computed from it on every
    rank."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _moe_mlp_ep(x: torch.Tensor, p, cfg: ArchConfig, mesh, axis: str, *,
                use_kernel: bool = False):
    """Expert-parallel ``moe_mlp`` over ``mesh``'s ``axis``: this rank holds
    (``p``'s expert leaves) and runs experts [r n_local, (r + 1) n_local) of
    its index r; the router, top-k and shared expert are replicated. The
    partial y is all-reduced in fp32; the aux loss from the local slice of
    the importance times the local counts, all-reduced with the dropped
    assignments in one fp32 sum. Differentiable (``_Replicated`` on the way
    in, ``_Summed`` on the way out)."""
    if isinstance(x, DTensor):  # a DTensor mesh: the expert split of _moe_mlp_mesh
        if axis != "model" or x.device_mesh != mesh:
            raise ValueError(f"a DTensor MoE splits its experts over its own mesh's 'model' "
                             f"axis; the table names {axis!r}")
        return _moe_mlp_mesh(x, p, cfg, use_kernel=use_kernel)
    e = cfg.moe
    group, ep, rank = axis_group(mesh, axis)
    if e.n_experts % ep:
        raise ValueError(f"{e.n_experts} experts do not split over {ep} ranks")
    n_local = e.n_experts // ep
    if p["w_up"].shape[0] != n_local:
        raise ValueError(f"rank {rank} of {ep} holds {p['w_up'].shape[0]} experts; expert "
                         f"parallelism expects its {n_local} (init_moe_mlp(experts=...))")
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    xr, router = _Replicated.apply(xf, group), _Replicated.apply(p["router"], group)
    _, probs, gate_vals, expert_idx = route(xr, router, cfg, use_kernel=use_kernel)
    y, counts, keep = _expert_compute(xr, p, cfg, n_local, rank * n_local, gate_vals,
                                      expert_idx, capacity(t, cfg), use_kernel=use_kernel)
    y = _Summed.apply(y.float(), group).to(x.dtype)
    me_local = probs.mean(0)[rank * n_local:(rank + 1) * n_local]
    sums = _Summed.apply(torch.stack([torch.sum(me_local * counts.float()),
                                      (counts.sum() - keep.sum()).float()]), group)
    aux = e.n_experts * sums[0] / (t * e.top_k)
    if "shared" in p:
        y = y + mlp(xf, p["shared"], "silu", use_kernel=use_kernel)
    return y.reshape(b, s, d), aux, sums[1].long()


def _moe_mlp_mesh(x: DTensor, p, cfg: ArchConfig, *, use_kernel: bool = False):
    """``moe_mlp`` of a DTensor, as the module's docstring describes: the
    dispatch of ``_expert_compute`` on each rank's tokens and experts, with
    the global slots' offsets and the buffers' trip through the mesh. The
    local tensors carry the gradients' placements: each rank's share of a
    sum over the mesh dims that split the work (the tokens' data axes, and
    ``model`` where it splits the experts) wherever the tensor is
    replicated along one: the router's and the input's (the gates, the aux
    loss and the dispatch of this rank's tokens), the gathered expert
    outputs' (each rank reads its tokens' rows) and the experts' where the
    slots are split over the data axes (a capacity that the data axes do
    not divide leaves every slot on every rank of them, and the output's
    gradient is summed over them first). The dropped assignments are a
    DTensor: this rank's experts', summed over ``model``."""
    e, mesh = cfg.moe, x.device_mesh
    k, n_e = e.top_k, e.n_experts
    b, s, d = x.shape
    t = b * s
    names = mesh.mesh_dim_names
    pl_x = fitted_placements((dp_spec(mesh), None, None), x)    # tokens over the data axes
    x = x.redistribute(mesh, pl_x)
    tok = [i for i, pl in enumerate(pl_x) if pl.is_shard()]      # mesh dims splitting tokens
    m_dim = names.index("model")
    ep = mesh.size(m_dim) if n_e % mesh.size(m_dim) == 0 else 1
    n_local = n_e // ep
    lo = (mesh.get_local_rank(m_dim) if ep > 1 else 0) * n_local
    split = [i in tok or (i == m_dim and ep > 1) for i in range(mesh.ndim)]

    def part(pls):  # a gradient that is each rank's share of a sum over the split dims
        return tuple(Partial() if split[i] and pl.is_replicate() else pl
                     for i, pl in enumerate(pls))

    def over(local, pls):  # a DTensor of this rank's local tensor
        return DTensor.from_local(local, mesh, tuple(pls), run_check=False)

    xl = x.to_local(grad_placements=part(pl_x)).reshape(-1, d)   # (T_loc, d)
    whole = (Replicate(),) * mesh.ndim
    router = p["router"].redistribute(mesh, whole).to_local(grad_placements=part(whole))
    _, probs, gate_vals, expert_idx = route(xl, router, cfg, use_kernel=use_kernel)

    # the global slots: the (choice, expert) counts of every token-splitting rank
    r = 0
    for i in tok:  # this rank's block of tokens, in the mesh dims' order
        r = r * mesh.size(i) + mesh.get_local_rank(i)
    seen = {}

    def global_offsets(count):  # (k, n_local) -> the assignments before each, globally
        seen["all"] = over(count[None], (Shard(0) if i in tok else Replicate()
                                         for i in range(mesh.ndim))).full_tensor()
        per_choice = seen["all"].sum(0)                          # (k, n_local)
        return (torch.cumsum(per_choice, 0) - per_choice) + seen["all"][:r].sum(0)

    # each rank's buffers, reduce-scattered over the data axes along the
    # capacity (each slot holds one token's row, so the sum is exact): each
    # rank runs its experts on its share of the slots
    cap = capacity(t, cfg)
    n_tok = math.prod(mesh.size(i) for i in tok)
    rows_split = n_tok > 1 and cap % n_tok == 0
    whole_pl = tuple(Shard(0) if i == m_dim and ep > 1 else Replicate()
                     for i in range(mesh.ndim))
    rows_pl = tuple(Shard(1) if i in tok and rows_split else pl for i, pl in enumerate(whole_pl))
    w = {n: gathered(p[n]) for n in ("w_up", "w_gate", "w_down")}
    w = {n: t.to_local(grad_placements=part(t.placements) if rows_split else t.placements)
         for n, t in w.items()}

    def on_slots(buf):
        buf = over(buf, (Partial() if i in tok else pl for i, pl in enumerate(whole_pl)))
        out = over(_experts(buf.redistribute(mesh, rows_pl).to_local(), w, use_kernel), rows_pl)
        return out.redistribute(mesh, whole_pl).to_local(grad_placements=part(whole_pl))

    y, _, _ = _expert_compute(xl, w, cfg, n_local, lo, gate_vals, expert_idx, cap,
                              use_kernel=use_kernel, offsets=global_offsets, on_slots=on_slots)
    # the parts of this rank's experts, summed over model in fp32
    y = over(y.float().reshape(x.to_local().shape),
             (Partial() if i == m_dim and ep > 1 else pl for i, pl in enumerate(pl_x)))
    y = y.redistribute(mesh, pl_x).to(x.dtype)

    # aux: this rank's tokens' importance of its experts times their global counts
    counts = seen["all"].sum((0, 1))                             # (n_local,), dropped included
    share = torch.sum(probs[:, lo:lo + n_local].sum(0) * counts.float())
    aux = over(share, (Partial() if split[i] else Replicate() for i in range(mesh.ndim)))
    aux = n_e * aux.redistribute(mesh, whole) / (t * t * k)  # a DTensor, as the loss it joins
    dropped = over(torch.clamp(counts - cap, min=0).sum(),
                   (Partial() if i == m_dim and ep > 1 else Replicate()
                    for i in range(mesh.ndim)))
    if "shared" in p:
        y = y + mlp(x, p["shared"], "silu", use_kernel=use_kernel)
    return y, aux, dropped


def init_block(generator: torch.Generator, cfg: ArchConfig, dtype=torch.float32, *,
               device="cpu"):
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device=device),
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                               dtype, device=device),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device=device),
        "moe": init_moe_mlp(generator, cfg, dtype, device=device),
    }


def init_lm(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
            dtype=torch.float32):
    """Random weights from ``generator`` at the JAX initialisers' scales."""
    device = _device(device)
    return {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype, device=device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab, dtype, device=device),
        "blocks": _stack([init_block(generator, cfg, dtype, device=device)
                          for _ in range(cfg.n_layers)]),
        "ln_f": init_rmsnorm(cfg.d_model, dtype, device=device),
    }


def block_apply(x, bp, cfg: ArchConfig, attn_fn=None, *, use_kernel: bool = False):
    """One block of the prefill forward: (x + attention + MoE, aux loss)."""
    x = x + gqa_attention(rms_norm(x, bp["ln1"], use_kernel=use_kernel), bp["attn"],
                          cfg.n_heads, cfg.n_kv, rope=cfg.rope, rope_theta=cfg.rope_theta,
                          window=cfg.window, attn_fn=attn_fn, use_kernel=use_kernel)
    y, aux, _ = moe_mlp(rms_norm(x, bp["ln2"], use_kernel=use_kernel), bp["moe"], cfg,
                        use_kernel=use_kernel)
    return x + y, aux


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, *, compute_dtype=torch.bfloat16,
            remat: str = "full", use_kernel: bool = True):
    """tokens (B, S) integer -> (logits (B, S, vocab) fp32, mean aux loss)."""
    x = constrain(embed(params["embed"], tokens, compute_dtype), "act")
    attn_fn = flash_attn_fn if use_kernel else None
    body = rematted(block_apply, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in unstack(params["blocks"], cfg.n_layers):
        x, a = body(x, bp, cfg, attn_fn, use_kernel=use_kernel)
        x = constrain(x, "act")
        aux = aux + a
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    logits = constrain(linear(x, params["lm_head"], use_kernel).float(), "logits")
    return logits, aux / cfg.n_layers


def loss_fn(params, cfg: ArchConfig, tokens, labels, aux_weight: float = 0.01,
            **kw) -> torch.Tensor:
    logits, aux = forward(params, cfg, tokens, **kw)
    return softmax_xent(logits, labels) + aux_weight * aux


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
               device="cuda"):
    device = _device(device)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16, use_kernel: bool = True):
    """tokens (B, 1) integer; pos (B,) integer -> (logits (B, vocab), new cache).
    The B tokens of a tick are routed together (capacity from T = B). The
    cache passed in is not changed."""
    x = constrain(embed(params["embed"], tokens, compute_dtype), "dec")
    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        bp = layer(params["blocks"], i)
        out, k_c, v_c = gqa_decode_attention(
            rms_norm(x, bp["ln1"], use_kernel=use_kernel), bp["attn"], cfg.n_heads, cfg.n_kv,
            cache["k"][i], cache["v"][i], pos, rope=cfg.rope, rope_theta=cfg.rope_theta,
            use_kernel=use_kernel)
        x = x + out
        y, _, _ = moe_mlp(rms_norm(x, bp["ln2"], use_kernel=use_kernel), bp["moe"], cfg,
                          use_kernel=use_kernel)
        x = constrain(x + y, "dec")
        k_new.append(k_c)
        v_new.append(v_c)
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    logits = linear(x[:, 0], params["lm_head"], use_kernel).float()
    return logits, {"k": torch.stack(k_new), "v": torch.stack(v_new)}
