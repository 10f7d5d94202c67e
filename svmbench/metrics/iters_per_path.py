"""FISTA iterations of a path's accepted solves (the port's
``solver_iters``), the mean over the window's untraced paths."""

import numpy as np

UNIT = "iters"


def read(run):
    recs = run.untraced()
    if not recs:
        return None
    return float(np.mean([np.sum(r["iters"]) for r in recs]))
