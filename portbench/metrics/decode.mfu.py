"""Model operations of every occupied slot's token in the window's ticks
(counted from the configuration's shapes at each slot's position) over the
window's seconds times the bf16 peak."""
from portbench.harness import work


def read(run):
    if not run.steps or "positions" not in run.steps[0]:
        return None
    base = work.decode_token_flops(run.arch, 0)
    per_pos = work.decode_token_flops(run.arch, 1) - base
    ops = sum(len(s["positions"]) * base + per_pos * sum(s["positions"]) for s in run.steps)
    return 100.0 * ops / (run.window_s * work.PEAK_BF16_FLOPS)
