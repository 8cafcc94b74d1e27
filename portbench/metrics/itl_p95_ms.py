"""95th percentile of the gaps between successive generated tokens of each
request, over every gap whose two tokens reached the host in the window."""
import numpy as np


def read(run):
    if not run.steps or "tick" not in run.steps[0]:
        return None
    gaps = run.driver.itl_gaps_s(run, run.state, run.steps[0]["tick"], run.steps[-1]["tick"])
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
