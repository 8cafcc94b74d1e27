"""Share of the window in which the device had nothing to run: one minus
the device's busy time a step in the traced segment (the profiler's
device-alone pass: the union of its kernels, copies and sets) over the
untraced window's wall time a step. (The traced pass's own window is
stretched by the profiler's cost a launch wherever the host paces the
step; ``device.busy_s`` and ``device.window_s`` of the result line are
that pass's, as measured.)"""


def read(run):
    if run.devtrace is None or not run.traced_steps or "s" not in run.traced_steps[0]:
        return None
    busy_a_step = run.devtrace.busy_s / len(run.traced_steps)
    return 100.0 * (1.0 - busy_a_step / (run.window_s / len(run.steps)))
