"""The traced paths' useful work at the chip's bound
(``harness/roofline.py``: the solver's two sweeps over each step's reduced
problem and one screen sweep a step) over the traced window, in %. None
without a device trace."""

from svmbench.harness import roofline

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    recs = run.records[:run.traced]
    bound = sum(roofline.path_bound_s(r, run.m, run.n, run.elem_bytes) for r in recs)
    return 100.0 * bound / t.window_s
