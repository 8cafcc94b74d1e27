"""Plain float32 reference of the dense decoder LM (StarCoder2's family as
the configuration file states it): token embedding; each block adds
grouped-query attention with rotary positions (in a sliding window where
the configuration sets one) over an RMSNorm of the residual stream, then
an MLP over a second RMSNorm; a final RMSNorm and the output head.

``make_weights`` draws the benchmark's weights from the seed on the
generator's device, one call a stacked leaf, in the type they are served
in; their layout is the tree the program takes (blocks stacked along a
leading layer axis, each product's weight as (K, N)). The reference reads
them and computes everything else again.
"""
from __future__ import annotations

import math

import torch

from . import common as c


def branches(arch: dict) -> int:
    """Residual branches of the model: attention and MLP in every block."""
    return 2 * arch["n_layers"]


def make_weights(arch: dict, init: dict, gen: torch.Generator, dtype=torch.bfloat16) -> dict:
    L, d, H, KV, f, V = (arch[k] for k in ("n_layers", "d_model", "n_heads", "n_kv", "d_ff",
                                            "vocab"))
    hd = d // H
    out = init["branch_out_std"] / math.sqrt(branches(arch))

    def norm_scale(*shape):
        return c.normal_(shape, init["norm_scale_std"], gen, dtype).add_(1.0)

    mlp = {"w_up": c.normal_((L, d, f), 1 / math.sqrt(d), gen, dtype),
           "w_down": c.normal_((L, f, d), out / math.sqrt(f), gen, dtype)}
    if arch.get("gated_mlp", True):
        mlp["w_gate"] = c.normal_((L, d, f), 1 / math.sqrt(d), gen, dtype)
    return {
        "embed": c.normal_((V, d), init["embed_std"], gen, dtype),
        "blocks": {
            "ln1": {"scale": norm_scale(L, d)},
            "attn": {"wq": c.normal_((L, d, H * hd), 1 / math.sqrt(d), gen, dtype),
                     "wk": c.normal_((L, d, KV * hd), 1 / math.sqrt(d), gen, dtype),
                     "wv": c.normal_((L, d, KV * hd), 1 / math.sqrt(d), gen, dtype),
                     "wo": c.normal_((L, H * hd, d), out / math.sqrt(H * hd), gen, dtype)},
            "ln2": {"scale": norm_scale(L, d)},
            "mlp": mlp,
        },
        "ln_f": {"scale": norm_scale(d)},
        "lm_head": c.normal_((d, V), 1 / math.sqrt(d), gen, dtype),
    }


def attention_block(x, p, arch: dict, precision: str):
    """Grouped-query causal self attention of x (S, d) with rotary positions."""
    s = x.shape[0]
    H, KV = arch["n_heads"], arch["n_kv"]
    hd = p["wq"].shape[1] // H
    theta = arch.get("rope_theta", 10000.0)
    q = c.linear(x, p["wq"], precision).reshape(s, H, hd)
    k = c.linear(x, p["wk"], precision).reshape(s, KV, hd)
    v = c.linear(x, p["wv"], precision).reshape(s, KV, hd)
    if arch.get("rope", True):
        q, k = c.rope(q, theta), c.rope(k, theta)
    return c.linear(c.causal_attention(q, k, v, window=arch.get("window")), p["wo"], precision)


def mlp_block(x, p, activation: str, precision: str):
    h = c.ACTIVATIONS[activation](c.linear(x, p["w_up"], precision))
    if "w_gate" in p:
        h = h * c.linear(x, p["w_gate"], precision)
    return c.linear(h, p["w_down"], precision)


def logits(weights: dict, arch: dict, tokens: torch.Tensor, *, eps: float,
           precision: str = "fp32") -> torch.Tensor:
    """tokens (S,) -> next-token logits (S, vocab) in float32."""
    with c.full_fp32():
        x = weights["embed"][tokens].float()
        blocks = weights["blocks"]
        for i in range(arch["n_layers"]):
            attn = {k: w[i] for k, w in blocks["attn"].items()}
            x = x + attention_block(c.rms_norm(x, blocks["ln1"]["scale"][i], eps), attn, arch,
                                    precision)
            mlp = {k: w[i] for k, w in blocks["mlp"].items()}
            x = x + mlp_block(c.rms_norm(x, blocks["ln2"]["scale"][i], eps), mlp,
                              arch["activation"], precision)
        x = c.rms_norm(x, weights["ln_f"]["scale"], eps)
        return c.linear(x, weights["lm_head"], precision)
