"""The frozen work counts against counts by hand at small shapes."""
import pytest

from portbench.harness import work

DENSE = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv": 1, "d_ff": 16,
         "vocab": 10, "gated_mlp": False}


def test_matmul_work():
    assert work.matmul_work(3, 5, 7) == (2 * (15 + 35 + 21), 2 * 3 * 5 * 7)
    assert work.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 989e12) == pytest.approx(1.0)


def test_products_dense():
    # per block: wq 8x8, wk 8x4, wv 8x4, wo 8x8, up 8x16, down 16x8; head 8x10
    assert work.products(DENSE) == {(8, 8): 4, (8, 4): 4, (8, 16): 2, (16, 8): 2, (8, 10): 1}
    assert work.product_params(DENSE) == 2 * (64 + 32 + 32 + 64 + 128 + 128) + 80


def test_prefill_flops():
    b, s = 2, 5
    attn = 2 * (2 * 2 * 4 * sum(t + 1 for t in range(s))) * b   # QKᵀ and PV, causal, 2 heads
    assert work.prefill_flops(DENSE, b, s) == 2 * b * s * work.product_params(DENSE) + 2 * attn


def test_decode_counts():
    assert work.decode_token_flops(DENSE, 3) == (2 * work.product_params(DENSE)
                                                 + 2 * 4 * 2 * 4 * 4)
    kv_token = 2 * 1 * 4 * 2
    assert work.decode_tick_bytes(DENSE, [0, 3]) == (2 * work.product_params(DENSE)
                                                     + 2 * kv_token * (3 + 2))
