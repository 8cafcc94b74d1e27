"""Share of the window's occupied slot-ticks that generated a token (the
rest teacher-force a prompt token): the sums of the ``generated`` and
``busy`` attrs of the window's ``serve.tick`` spans, from the batcher's
ring."""
from portbench.harness import spans


def read(run):
    ticks = spans.window_ticks(run)
    if ticks is None:
        return None
    busy = sum(tick["attrs"]["busy"] for tick, _ in ticks)
    return 100.0 * sum(tick["attrs"]["generated"] for tick, _ in ticks) / busy
