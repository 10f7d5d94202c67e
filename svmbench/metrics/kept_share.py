"""The screens' kept share: the reduced problems' features times samples,
summed over a path's steps, over ``T m n``; the mean over the window's
untraced paths, in %."""

import numpy as np

from svmbench.harness import roofline

UNIT = "%"


def read(run):
    recs = run.untraced()
    if not recs:
        return None
    return 100.0 * float(np.mean([roofline.kept_share(r, run.m, run.n) for r in recs]))
