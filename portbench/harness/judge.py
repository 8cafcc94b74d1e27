"""How ``correct`` is decided: the program's served tokens against the plain
reference, once the window has closed.

A judged sequence is the token ids fed (``tokens``), the positions at
which the program chose a next token (``positions``) and what it chose
(``served``). The reference runs once over the sequence in float32; at
each judged position the gap is how far the served token's reference logit
lies below the reference's best there. The number compared is the mean gap
over every judged position of the run (``gap_mean``), with its limit in the
cell's file; the widest gap (``gap``) is read and printed beside it. (The
widest gap grows with the logits' error; the mean with its square, since
both the share of positions whose best two the error swaps and the gap at
each grow with it: so the mean separates the program's bf16 from the
float8 control by about ten times where the widest did by two to three,
PERF.md.) A sequence whose reference logits are not finite, or that judges
no position, fails.

The control (``control_judged``) puts the reference in the program's place
at the precision below the configuration's (``control_precision``): at
each judged position of the same sequences it serves the token its own
logits put first, and those served tokens go through ``readings``,
``compared`` and ``correct`` as the program's do, against the same limits.
"""
from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class Judged:
    tokens: torch.Tensor     # (S,) ids fed to the model
    positions: torch.Tensor  # (J,) positions whose next token was served
    served: torch.Tensor     # (J,) the served tokens


def readings(judged: list, ref, weights: dict, config: dict) -> dict:
    """Per-sequence widest gaps, the overall widest and the mean gap of the
    served tokens below the reference's best."""
    eps = config["norm_eps"]
    arch = config["arch"]
    t0 = time.perf_counter()
    gaps, failed, positions, total = [], 0, 0, 0.0
    with torch.inference_mode():
        for j in judged:
            logits = ref.logits(weights, arch, j.tokens, eps=eps)[j.positions]
            ok = bool(torch.isfinite(logits).all()) and len(j.positions) == len(j.served) > 0
            if ok:
                gap = logits.max(-1).values - logits.gather(-1, j.served[:, None].long())[:, 0]
                gaps.append(float(gap.max()))
                total += float(gap.sum())
            else:
                failed += 1
                gaps.append(float("inf"))
                total = float("inf")
            positions += len(j.positions)
            del logits
    return {"gap_mean": total / max(positions, 1), "gap": max(gaps), "gaps": gaps,
            "sequences": len(judged), "positions": positions, "failed": failed,
            "reference_s": time.perf_counter() - t0}


def control_judged(judged: list, ref, weights: dict, config: dict) -> list:
    """The same sequences and positions, served by the reference at the
    configuration's ``control_precision``: its first choice at each."""
    out = []
    with torch.inference_mode():
        for j in judged:
            low = ref.logits(weights, config["arch"], j.tokens, eps=config["norm_eps"],
                             precision=config["control_precision"])[j.positions]
            out.append(Judged(tokens=j.tokens, positions=j.positions, served=low.argmax(-1)))
    return out


def compared(read: dict, limits: dict) -> dict:
    """Each number compared, with its limit: {name: {"value", "limit"}}."""
    return {name: {"value": read[name], "limit": limit} for name, limit in limits.items()}


def correct(cmp: dict, read: dict) -> bool:
    return read["failed"] == 0 and all(v["value"] <= v["limit"] for v in cmp.values())
