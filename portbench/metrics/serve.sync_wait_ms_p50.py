"""Median over the window's ticks of the program's ``serve.sync`` span
(``argmax(...).cpu()``, the tick's one wait on the device), from the
batcher's ring: near 0 where the host paces the tick."""
import statistics

from portbench.harness import spans


def read(run):
    ticks = spans.window_ticks(run)
    if ticks is None:
        return None
    return statistics.median(sync for _, sync in ticks) * 1e3
