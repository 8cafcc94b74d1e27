"""The yardstick: published peaks of the chip and the work a model needs,
counted from the configuration's shapes (never from the program).

Operations are 2 a multiply-add. A product (M, K) @ (K, N) needs 2·M·K·N
operations and reads each operand once and writes the result once. Causal
attention needs, per head, the dot products of each query with the keys up
to its own position, for QKᵀ and again for PV (a sliding window as wide as
the longest sequence changes nothing). The product shapes are those of
``chip_smoke.py::lm_products``, copied here so that no later change to the
program moves them.
"""
from __future__ import annotations

# NVIDIA H100 SXM, published dense rates (no sparsity) at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2  # bytes an element


def matmul_work(m: int, k: int, n: int, elem: int = BF16) -> tuple[float, float]:
    """(bytes, operations) of one (M, K) @ (K, N) product."""
    return elem * (m * k + k * n + m * n), 2.0 * m * k * n


def least_s(nbytes: float, ops: float) -> float:
    """The least seconds of work on the chip: the larger of its operations
    over the bf16 peak and its bytes over the memory rate."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def products(arch: dict) -> dict:
    """(K, N) -> how many products of that shape a token's forward makes
    (``chip_smoke.py::lm_products``)."""
    d, hd = arch["d_model"], arch["d_model"] // arch["n_heads"]
    block = [(d, arch["n_heads"] * hd), (d, arch["n_kv"] * hd), (d, arch["n_kv"] * hd),
             (arch["n_heads"] * hd, d), (d, arch["d_ff"]), (arch["d_ff"], d)]
    if arch.get("gated_mlp", True):
        block.append((d, arch["d_ff"]))
    per_model = [(kn, arch["n_layers"]) for kn in block]
    per_model.append(((d, arch["vocab"]), 1))
    counts: dict = {}
    for kn, n in per_model:
        counts[kn] = counts.get(kn, 0) + n
    return counts


def product_params(arch: dict) -> int:
    """Weights that the products read (the embedding gather is not a product)."""
    return sum(k * n * c for (k, n), c in products(arch).items())


def prefill_matmul_work(arch: dict, b: int, s: int) -> tuple[float, float]:
    """(bytes, operations) of the products of one prefill of (b, s)."""
    nbytes = ops = 0.0
    for (k, n), c in products(arch).items():
        nb, op = matmul_work(b * s, k, n)
        nbytes, ops = nbytes + c * nb, ops + c * op
    return nbytes, ops


def prefill_matmul_least_s(arch: dict, b: int, s: int) -> float:
    """The least seconds of the products of one prefill of (b, s), each
    product bounded on its own."""
    return sum(c * least_s(*matmul_work(b * s, k, n)) for (k, n), c in products(arch).items())


def prefill_flops(arch: dict, b: int, s: int) -> float:
    """Model operations of one prefill of (b, s): the products and causal
    attention (each query with the keys up to its own, QKᵀ and PV)."""
    hd = arch["d_model"] // arch["n_heads"]
    ops = prefill_matmul_work(arch, b, s)[1]
    return ops + arch["n_layers"] * 2.0 * b * arch["n_heads"] * hd * s * (s + 1)


def decode_token_flops(arch: dict, pos: int) -> float:
    """Model operations of one token at position ``pos`` (0-based) of a decode
    step: the products and attention over pos + 1 keys."""
    hd = arch["d_model"] // arch["n_heads"]
    return 2.0 * product_params(arch) + arch["n_layers"] * 4.0 * arch["n_heads"] * hd * (pos + 1)


def decode_tick_bytes(arch: dict, positions: list[int]) -> float:
    """Least bytes of one decode step over the sequences at ``positions``:
    every product's weight read once; per layer each sequence's cached keys
    and values before its position read once and its new ones written once
    (bf16)."""
    hd = arch["d_model"] // arch["n_heads"]
    kv_token = 2 * arch["n_kv"] * hd * BF16
    nbytes = BF16 * product_params(arch)
    return float(nbytes + arch["n_layers"] * kv_token * (sum(positions) + len(positions)))
