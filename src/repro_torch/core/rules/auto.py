"""``rules="auto"``: per-step rule-stack selection from telemetry.

Port of the reference ``core/rules/auto.py``. Running several rules and
intersecting their keeps pays when the solver time it saves exceeds the
extra sweep's cost. The policy:

* The EDPP bound is always evaluated: it takes the one read of X the VI
  bound takes and is never looser (:mod:`.edpp`).
* The one optional sweep is the DVI old-anchor VI bound (one more read of
  X). Every ``probe_every`` steps it runs, and the rule records how many
  more features it screened and what it cost; between probes it runs only
  while

      (extra features screened) x (EMA solve seconds per kept feature)
          > (sweep seconds).

  ``PathDriver`` feeds each step's solve wall in through :meth:`observe`.

Every candidate bound is safe, so any intersection is: the policy decides
the spend, never correctness. On a CUDA X a step is one launch of the
feature-screen kernel's EDPP mode, plus one VI-mode launch from the old
anchor while the extra sweep runs or at a probe. A probe waits for the card
before it reads its clock (the one device sync the rule adds), so its
sweep seconds are the device's. On a grid of ranks (``PathDriver(grid=)``)
each rank reads its own clock, so rank 0's decision is the one every rank
takes (:meth:`AutoRule.select`'s ``agree``).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ...kernels.ops import screen_bounds_from_shared
from ..screening import SAFE_TAU, shared_scalars
from .base import ConvexRegion, register_rule
from .edpp import edpp_region_bounds
from .feature_vi import FeatureVIRule

__all__ = ["AutoRule"]


@register_rule("auto")
class AutoRule(FeatureVIRule):
    """EDPP always; the DVI old-anchor sweep when its measured payoff covers
    its measured cost. Its program (engines with no host in the loop) is
    ``edpp``."""

    program = "edpp"

    def __init__(self, tau: float = SAFE_TAU, probe_every: int = 3):
        super().__init__(tau=tau)
        self.probe_every = int(probe_every)
        self._anchor: Optional[tuple] = None   # (lam0, theta0, delta0)
        self._solve_per_feat: Optional[float] = None  # EMA s / kept feature
        self._use_extra = False
        self._since_probe = 0
        self.telemetry: list[dict] = []

    def prepare(self, X: torch.Tensor, y: torch.Tensor) -> None:
        self._anchor = None
        self._use_extra = False
        self._since_probe = 0
        self.telemetry = []

    def observe(self, *, solve_seconds: float, kept: int, **_) -> None:
        """Fold one step's solve wall into the cost model (EMA)."""
        per = float(solve_seconds) / max(int(kept), 1)
        self._solve_per_feat = (per if self._solve_per_feat is None
                                else 0.5 * self._solve_per_feat + 0.5 * per)

    def bounds(self, X: torch.Tensor, y: torch.Tensor,
               region: ConvexRegion) -> torch.Tensor:
        def old_vi(anchor):
            lam0, theta0, delta0 = anchor
            sh0 = shared_scalars(y, lam0, region.lam2, theta0, delta=delta0)
            return screen_bounds_from_shared(X, y, theta0, sh0)

        b = self.select(edpp_region_bounds(X, y, region), region.lam2, old_vi)
        self._anchor = (region.lam1, region.theta1, region.delta)
        return b

    def select(self, b: torch.Tensor, lam2: float, old_vi, count=None,
               agree=None) -> torch.Tensor:
        """The policy on one step: ``b`` is the EDPP bound, ``old_vi(anchor)``
        the VI bound of the older anchor ``self._anchor`` targeting ``lam2``
        (run when the extra sweep is on, or at a probe). A grid of ranks
        passes ``count`` (the kept counts summed over the feature axis) and
        ``agree`` (the decision every rank takes: rank 0's, whose clock
        decides). Returns the step's bound; the caller sets the next older
        anchor."""
        anchor = self._anchor
        probe = self._since_probe >= self.probe_every
        step_info = dict(extra_swept=False, extra_screened=0, sweep_s=0.0)
        # the older anchor certifies theta*(lam2) only when lam0 > lam2
        if anchor is not None and anchor[0] > lam2 and (self._use_extra or probe):
            t0 = time.perf_counter()
            both = torch.minimum(b, old_vi(anchor))
            # the copy to the host waits for both sweeps: an honest wall
            kept = torch.stack([self.keep(b).sum(), self.keep(both).sum()])
            kept = (kept if count is None else count(kept)).cpu()
            sweep_s = time.perf_counter() - t0
            extra = int(kept[0] - kept[1])
            use = extra * (self._solve_per_feat or 0.0) > sweep_s
            self._use_extra = use if agree is None else agree(use)
            self._since_probe = 0
            b = both
            step_info = dict(extra_swept=True, extra_screened=extra,
                             sweep_s=sweep_s)
        else:
            self._since_probe += 1
        self.telemetry.append(dict(lam2=float(lam2), use_extra=self._use_extra,
                                   **step_info))
        return b
