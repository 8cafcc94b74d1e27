"""Tokens generated (not teacher-forced) in the window's ticks, over the
window's seconds (host clock; a tick ends with its tokens on the host)."""


def read(run):
    if not run.steps or "out" not in run.steps[0]:
        return None
    return sum(s["out"] for s in run.steps) / run.window_s
