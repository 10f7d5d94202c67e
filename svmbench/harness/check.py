"""Whether the paths that the window produced are correct.

After the window closes, every path it finished is judged by the float64
reference (``svmbench/reference/svm64.py``) on its own training fold,
gathered again from the run's data. A path's number is its worst step; the
run's is its worst path. The traffic file's ``limits`` say which numbers
are compared and the largest each may read; the others are printed beside
them. A number that is not finite fails its limit, and so does a path that
raised.
"""

from __future__ import annotations

import math

import numpy as np

from svmbench.reference import svm64

NUMBERS = ("lam_max_rel", "obj_rel", "kkt_rel", "gap_rel", "screen_ratio",
           "sample_slack", "cert_factor")


def readings(feed, records: list) -> dict:
    """The worst reading of each number over ``records``, each judged on
    the fold it was solved on."""
    worst = {k: -math.inf for k in NUMBERS}
    for rec in records:
        Xf, yf = feed.load(rec["round"], rec["fold"])
        r = svm64.judge(Xf, yf, rec)
        for k in NUMBERS:
            v = float(np.max(r[k]))
            worst[k] = v if not math.isfinite(v) else max(worst[k], v)
    return {k: (v if records else math.nan) for k, v in worst.items()}


def verdict(worst: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` for the compared numbers."""
    compared = {k: {"value": worst[k], "limit": float(v)} for k, v in limits.items()}
    ok = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                             for c in compared.values())
    return ok, compared
