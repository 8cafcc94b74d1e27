"""Share of the traced host-and-device pass's device time in the ops
launched inside the program's ``attn.cache_read`` span (scores, scale,
mask, softmax and the PV product over the decode cache), each op given
to the innermost program span around its launch (``harness/spans.py``)."""
from portbench.harness import runner, spans


def read(run):
    return spans.span_share(run, runner.TRACE_DIR / f"{run.name}.{run.seed}", "attn.cache_read")
