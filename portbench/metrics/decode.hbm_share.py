"""Least bytes of the window's ticks (weights once a tick, each occupied
slot's cached K/V up to its position read once and its new K/V written
once) over the window's seconds times the HBM rate."""
from portbench.harness import work


def read(run):
    if not run.steps or "positions" not in run.steps[0]:
        return None
    nbytes = sum(work.decode_tick_bytes(run.arch, s["positions"]) for s in run.steps)
    return 100.0 * nbytes / (run.window_s * work.HBM_BYTES_PER_S)
