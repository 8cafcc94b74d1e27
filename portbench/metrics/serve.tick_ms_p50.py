"""Median of the benchmark's span around each ``ContinuousBatcher.step()``
in the window (host clock)."""
import statistics


def read(run):
    if not run.steps or "tick" not in run.steps[0]:
        return None
    return statistics.median(s["t1"] - s["t0"] for s in run.steps) * 1e3
