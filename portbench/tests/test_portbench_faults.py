"""A whole run (set-up, window, judge) on the CPU at a small size, with the
look for a chip skipped: sound, it is correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault such a cell
can have. (One chip: no exchange between chips to leave out.)"""
import functools

import pytest
import torch

from portbench.harness import runner
from small import small_cell

SEED = 2**31 + 11


def _half_prefill(f, params, cfg, batch, **kw):
    """Half of the batch left out: its rows get the other half's logits."""
    t = batch["tokens"]
    out = f(params, cfg, {"tokens": t[: t.shape[0] // 2]}, **kw)
    return torch.cat([out, out])


def _altered_prefill(f, params, cfg, batch, **kw):
    """A token altered where it is produced: token 7 put first at every 3rd position."""
    out = f(params, cfg, batch, **kw)
    out[:, ::3, 7] += 100.0
    return out


def _unchanged_decode(f, params, cfg, cache, tokens, pos, **kw):
    """A step that returns its state unchanged: the new K/V never kept."""
    logits, _ = f(params, cfg, cache, tokens, pos, **kw)
    return logits, cache


def _half_decode(f, params, cfg, cache, tokens, pos, **kw):
    logits, new = f(params, cfg, cache, tokens, pos, **kw)
    half = logits.shape[0] // 2
    logits[half:] = logits[:half]
    return logits, new


def _altered_decode(f, params, cfg, cache, tokens, pos, calls=[0], **kw):
    logits, new = f(params, cfg, cache, tokens, pos, **kw)
    calls[0] += 1
    if calls[0] % 5 == 0:
        logits[:, 7] += 100.0
    return logits, new


FAULTS = {
    "starcoder2-3b.prefill": {"prefill_logits": [_half_prefill, _altered_prefill]},
    "starcoder2-3b.decode": {"decode_step": [_unchanged_decode, _half_decode, _altered_decode]},
}
CASES = [(cell, fn, fault) for cell, by in FAULTS.items() for fn, faults in by.items()
         for fault in faults]


def _run(cell):
    """A prefill window of one cycle judges every row of its batches; a decode
    window of a second judges every request it completed."""
    seconds = 0.0 if "prefill" in cell else 1.0
    return runner.run_cell(small_cell(cell), SEED, seconds, False, device="cpu")


@pytest.mark.parametrize("cell", list(FAULTS))
def test_sound_run_is_correct(cell):
    result, read = _run(cell)
    assert result["correct"], result["compared"]
    assert read["positions"] > 0 and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {"setup_s", *(
        ("prefill_tokens_per_s",) if "prefill" in cell else ("decode_tokens_per_s",
                                                              "itl_p95_ms"))}


@pytest.mark.parametrize("cell,fn,fault", CASES, ids=lambda x: getattr(x, "__name__", x))
def test_broken_path_is_not_correct(cell, fn, fault, monkeypatch):
    from repro_torch.models import api
    monkeypatch.setattr(api, fn, functools.partial(fault, getattr(api, fn)))
    result, read = _run(cell)
    assert not result["correct"], (read["gaps"], result["compared"])


@pytest.mark.parametrize("cell", list(FAULTS))
def test_control_reads_above_the_program(cell):
    """The control (the reference in float8 in the program's place, judged by
    the same comparison) at this small size reads a mean gap above the
    program's bf16 one."""
    seconds = 0.0 if "prefill" in cell else 1.0
    _, read = runner.run_cell(small_cell(cell), SEED + 1, seconds, False, device="cpu",
                              control=True)
    low = read["control"]
    assert low["gap_mean"] > read["gap_mean"] and low["gap_mean"] > 0
    assert set(low["compared"]) == {"gap_mean"} and "correct" in low
