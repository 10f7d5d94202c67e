"""The FISTA sweeps' share of their roofline: the bound of the two sweeps'
useful bytes (``harness/roofline.py``) over the device time of the port's
margin and gradient kernels (``csrc/hinge.cu``: names holding
``margin_partial`` or ``hinge_grad``) in the traced window, in %. None
when the trace holds none of them."""

from svmbench.harness import roofline

UNIT = "%"
KERNELS = ("margin_partial", "hinge_grad")


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = sum(s for name, s in t.kernel_s.items() if any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    recs = run.records[:run.traced]
    bound = sum(roofline.sweep_bound_s(r, run.n, run.elem_bytes) for r in recs)
    return 100.0 * bound / secs
