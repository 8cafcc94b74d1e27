"""Median over the window's ticks of the host's own time in a tick: the
program's ``serve.tick`` span less its ``serve.sync`` (the wait on the
device), from the batcher's ring (``ContinuousBatcher.spans``)."""
import statistics

from portbench.harness import spans


def read(run):
    ticks = spans.window_ticks(run)
    if ticks is None:
        return None
    return statistics.median(tick["dur"] - sync for tick, sync in ticks) * 1e3
