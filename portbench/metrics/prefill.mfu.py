"""Model operations of the window's prefills (products, causal attention,
SSD; counted from the configuration's shapes) over the window's seconds
times the bf16 peak."""
from portbench.harness import work


def read(run):
    if not run.steps or "s" not in run.steps[0]:
        return None
    ops = sum(work.prefill_flops(run.arch, s["b"], s["s"]) for s in run.steps)
    return 100.0 * ops / (run.window_s * work.PEAK_BF16_FLOPS)
