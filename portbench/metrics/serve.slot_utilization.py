"""Occupied slot-ticks over all slot-ticks of the window, from the
``ContinuousBatcher``'s own counters (``steps``, ``busy_slot_steps``)."""


def read(run):
    c0, c1 = run.counters0, run.counters1
    if "busy_slot_steps" not in c1:
        return None
    ticks = c1["steps"] - c0["steps"]
    return 100.0 * (c1["busy_slot_steps"] - c0["busy_slot_steps"]) / (ticks * c1["slots"])
