"""The plain reference against the program's plain route (``use_kernel=False``)
on reduced configurations, in float32 on the CPU."""
import dataclasses

import pytest
import torch

from portbench.harness import spec
from portbench.reference import common

CONFIGS = [c["name"] for c in spec.load_spec()["configs"]]


def _reduced(name):
    from repro_torch.configs import get_config
    cfg = get_config(name).reduced()
    arch = dataclasses.asdict(cfg)
    config = next(c for c in spec.load_spec()["configs"] if c["name"] == name)
    return cfg, arch, spec.reference({"reference": _family(config)})


def _family(entry):
    import json
    return json.loads((spec.ROOT / entry["file"]).read_text())["reference"]


def _init(name):
    import json
    entry = next(c for c in spec.load_spec()["configs"] if c["name"] == name)
    return json.loads((spec.ROOT / entry["file"]).read_text())["init"]


@pytest.mark.parametrize("name,window", [(n, w) for n in CONFIGS for w in (None, 40)])
def test_reference_agrees_with_the_plain_route(name, window):
    """At 96 positions, with no window and with one of 40."""
    from repro_torch.models import api
    cfg, arch, ref = _reduced(name)
    cfg, arch = dataclasses.replace(cfg, window=window), dict(arch, window=window)
    gen = torch.Generator().manual_seed(5)
    weights = ref.make_weights(arch, _init(name), gen, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab, (2, 96), generator=gen)
    with torch.inference_mode():
        prog = api.prefill_logits(weights, cfg, {"tokens": tokens}, use_kernel=False,
                                  compute_dtype=torch.float32)
        for b in range(2):
            want = ref.logits(weights, arch, tokens[b], eps=1e-6)
            torch.testing.assert_close(prog[b], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_follow_the_seed_and_the_programs_layout(name):
    from repro_torch.models import api
    from repro_torch.tree import flatten
    cfg, arch, ref = _reduced(name)
    a = ref.make_weights(arch, _init(name), torch.Generator().manual_seed(1))
    b = ref.make_weights(arch, _init(name), torch.Generator().manual_seed(1))
    c = ref.make_weights(arch, _init(name), torch.Generator().manual_seed(2))
    prog = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    shapes = {p: tuple(t.shape) for p, t in flatten(prog)}
    assert {p: tuple(t.shape) for p, t in flatten(a)} == shapes
    assert all(t.dtype == torch.bfloat16 for _, t in flatten(a))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(flatten(a), flatten(b)))
    assert not torch.equal(a["embed"], c["embed"])


def test_causal_attention_blocks_and_groups():
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((9, 4, 8), generator=gen)
    k, v = torch.randn((9, 2, 8), generator=gen), torch.randn((9, 2, 8), generator=gen)
    full = common.causal_attention(q, k, v, rows=1024)
    torch.testing.assert_close(common.causal_attention(q, k, v, rows=4), full)
    h = 3  # head 3 reads KV head 1; query 4 sees keys 0..4
    w = torch.softmax(q[4, h] @ k[:5, 1].T / 8 ** 0.5, -1)
    torch.testing.assert_close(full.reshape(9, 4, 8)[4, h], w @ v[:5, 1])
    slid = common.causal_attention(q, k, v, rows=4, window=3)  # query 4 sees keys 2..4
    w = torch.softmax(q[4, h] @ k[2:5, 1].T / 8 ** 0.5, -1)
    torch.testing.assert_close(slid.reshape(9, 4, 8)[4, h], w @ v[2:5, 1])
    torch.testing.assert_close(common.causal_attention(q, k, v, window=9), full)


def test_fp8_control_rounds_the_products():
    gen = torch.Generator().manual_seed(6)
    x, w = torch.randn((16, 32), generator=gen), torch.randn((32, 8), generator=gen)
    exact = common.linear(x, w, "fp32")
    low = common.linear(x, w, "fp8")
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.2
    with pytest.raises(ValueError):
        common.linear(x, w, "int3")
