"""Prompt tokens whose logits the window completed, over the window's
seconds (host clock; every batch ends with its choices on the host)."""


def read(run):
    if not run.steps or "tokens" not in run.steps[0]:
        return None
    return sum(s["tokens"] for s in run.steps) / run.window_s
