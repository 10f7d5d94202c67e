"""Milliseconds a FISTA iteration: the solve seconds the port stamps
(``solve_times`` on the host engine: gathers, solves and verification
rounds; ``solve_seconds`` on the scan engine) over the iterations, summed
over the window's untraced paths."""

import numpy as np

UNIT = "ms"


def read(run):
    recs = run.untraced()
    iters = float(sum(np.sum(r["iters"]) for r in recs))
    if iters <= 0:
        return None
    return 1e3 * sum(r["solve_s"] for r in recs) / iters
