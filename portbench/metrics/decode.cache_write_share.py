"""Share of the traced host-and-device pass's device time in the ops
launched inside the program's ``attn.cache_write`` span (the decode
cache's one-hot blend of K and V), each op given to the innermost program
span around its launch (``harness/spans.py``)."""
from portbench.harness import runner, spans


def read(run):
    return spans.span_share(run, runner.TRACE_DIR / f"{run.name}.{run.seed}", "attn.cache_write")
