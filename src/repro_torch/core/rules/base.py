"""Screening-rule protocol, the shared region, and the rule registry.

Port of the reference ``core/rules/base.py``. A screening rule inspects the
region of the next path step's optimum and certifies that some units of
``X`` (feature rows or sample columns) cannot matter there:

* ``axis``   — which axis of ``X`` it reduces (``"features"`` or
  ``"samples"``);
* ``bounds`` — a per-unit score derived from the region;
* ``keep``   — which units survive, given those scores.

Rules that are not safe a priori (``needs_verification``, the sample rule)
also implement ``verify``: :func:`solve_with_verification` checks the
screened units at the solved point and re-admits violators before a step is
accepted.

:class:`ConvexRegion` is built once per path step and shared by the rules:
the dual anchor for feature rules, the primal anchor and trust radii for
sample rules. Rules register under a short name
(``@register_rule("feature_vi")``) so drivers and the launcher are
configured with strings.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..screening import SAFE_TAU, ScreenShared, shared_scalars

__all__ = [
    "ConvexRegion",
    "ScreeningRule",
    "register_rule",
    "get_rule",
    "available_rules",
    "make_rules",
    "solve_with_verification",
    "dynamic_tau",
    "AXIS_FEATURES",
    "AXIS_SAMPLES",
]

AXIS_FEATURES = "features"
AXIS_SAMPLES = "samples"


@dataclass(frozen=True)
class ConvexRegion:
    """What the rules may know about the optimum at ``lam2``.

    Dual side (always present): the VI set for ``theta*(lam2)``, from the
    anchor ``theta1`` at ``lam1`` with ``||theta1 - theta*(lam1)|| <=
    delta``; ``shared`` holds the set's scalars (paper Sec. 6.4),
    delta-inflated so the set still contains ``theta*(lam2)`` under inexact
    solves.

    Primal side (optional): ``(w1, b1)`` is the primal anchor matching
    ``theta1``, and ``(dw, db)`` are the driver's estimates of
    ``||w*(lam2) - w1||`` and ``|b*(lam2) - b1|``. ``dw = inf`` (the
    default) makes every margin bound vacuous, so sample rules keep
    everything. Tensors stay on the anchor's device.
    """

    y: torch.Tensor
    lam1: float
    lam2: float
    theta1: torch.Tensor
    delta: Union[float, torch.Tensor] = 0.0
    shared: Optional[ScreenShared] = None
    w1: Optional[torch.Tensor] = None
    b1: float = 0.0
    dw: float = float("inf")
    db: float = float("inf")

    @classmethod
    def build(cls, y: torch.Tensor, lam1, lam2, theta1: torch.Tensor,
              delta=0.0, w1: Optional[torch.Tensor] = None, b1=0.0,
              dw: float = float("inf"), db: float = float("inf")) -> "ConvexRegion":
        sh = shared_scalars(y, lam1, lam2, theta1, delta=delta)
        return cls(y=y, lam1=float(lam1), lam2=float(lam2), theta1=theta1,
                   delta=delta, shared=sh, w1=w1, b1=float(b1),
                   dw=float(dw), db=float(db))

    def with_primal(self, w1, b1, dw, db) -> "ConvexRegion":
        return replace(self, w1=w1, b1=float(b1), dw=float(dw), db=float(db))


class ScreeningRule:
    """Base class / protocol for screening rules.

    Subclasses set ``name`` and ``axis`` and implement ``bounds`` and
    ``keep``. ``prepare`` is a once-per-path hook (default: nothing);
    ``verify`` is needed only when ``needs_verification`` is True.
    """

    name: str = "base"
    axis: str = AXIS_FEATURES
    #: an a-priori safe rule never rejects a unit that matters; a rule with
    #: ``needs_verification=True`` is checked by :meth:`verify` at the
    #: solved point before the step is accepted
    needs_verification: bool = False
    #: the name of the rule's program in ``rules/programs.PROGRAMS`` (its
    #: bounds as a plain function of the region's stats), or ``None`` for a
    #: rule that has none (sample rules, containers)
    program: Optional[str] = None

    def refresh(self, X, y, w, b, lam, sample_mask=None) -> ConvexRegion:
        """The region rebuilt from the current iterate ``(w, b)`` at ``lam``
        mid-solve (dynamic screening): the duality gap there certifies a
        dual-feasible ``theta`` with ``||theta - theta*(lam)|| <= delta``
        (``solver.gap_theta_delta``), and the at-lambda region (``lam1 =
        lam2 = lam``) built from it tightens as the solve converges. Safe
        for any rule that is safe on a path step's region. ``sample_mask``
        restricts the certificate to the live samples."""
        from ..solver import gap_theta_delta  # lazy: the solver imports rules

        theta, delta, _ = gap_theta_delta(X, y, w, b, lam, sample_mask=sample_mask)
        return ConvexRegion.build(y, lam, lam, theta, delta=delta, w1=w,
                                  b1=float(b))

    def prepare(self, X: torch.Tensor, y: torch.Tensor) -> None:
        """Once-per-path hook (default: no-op)."""

    def bounds(self, X: torch.Tensor, y: torch.Tensor,
               region: ConvexRegion) -> torch.Tensor:
        raise NotImplementedError

    def keep(self, bounds: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def screen(self, X, y, region) -> tuple[torch.Tensor, torch.Tensor]:
        b = self.bounds(X, y, region)
        return self.keep(b), b

    def verify(self, X, y, w, b, screened_idx) -> torch.Tensor:
        """The entries of ``screened_idx`` (sample indices, a device tensor)
        that violate the certificate at ``(w, b)``."""
        raise NotImplementedError(f"rule {self.name!r} is a-priori safe")

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}(name={self.name!r}, axis={self.axis!r})"


_RULES: dict[str, type] = {}


def register_rule(name: str):
    """Class decorator: register a ScreeningRule under ``name``."""

    def deco(cls):
        cls.name = name
        _RULES[name] = cls
        return cls

    return deco


def available_rules() -> tuple[str, ...]:
    return tuple(sorted(_RULES))


def get_rule(name: str, **kwargs) -> ScreeningRule:
    """Instantiate a registered rule; an unknown name raises ``ValueError``
    naming the supported set."""
    try:
        cls = _RULES[name]
    except KeyError:
        raise ValueError(
            f"unknown screening rule {name!r}; this port supports "
            f"{available_rules()}") from None
    return cls(**kwargs)


def solve_with_verification(
    solve: Callable[[np.ndarray], tuple],
    sample_rules: Sequence[ScreeningRule],
    X: torch.Tensor,
    y: torch.Tensor,
    s_mask: np.ndarray,
    max_rounds: int = 3,
    violators: Optional[Callable] = None,
):
    """The verified sample-screening protocol (reference
    ``solve_with_verification``), on device tensors.

    ``solve(s_mask) -> (result, w_full, b)`` solves the reduced problem with
    the given host sample keep-mask; ``w_full`` (m,) and ``b`` live on X's
    device. The screened samples are then checked at the solution by each
    verifying rule against ``X`` and ``y`` on the device (X is never copied
    to the host); violators are re-admitted and the solve repeated. After
    ``max_rounds`` re-solves the mask is reset to every sample (an exact
    solve), so the loop ends and the accepted solution satisfies every
    screened sample's ``xi_i = 0`` certificate.

    ``violators`` (optional) replaces the rules' check for a sharded X: a
    function ``(w_full, b, screened host indices) -> host indices`` that
    every rank answers alike (``distributed.sample_violators_sharded``).

    Mutates ``s_mask`` in place; returns ``(result, w_full, b, rounds)``.
    """
    verifying = [r for r in sample_rules if r.needs_verification]
    rounds = 0
    while True:
        res, w_full, b = solve(s_mask)
        if s_mask.all() or not verifying:
            return res, w_full, b, rounds
        if violators is not None:
            viol = violators(w_full, b, np.nonzero(~s_mask)[0])
        else:
            scr_idx = torch.from_numpy(np.nonzero(~s_mask)[0]).to(X.device)
            viol = torch.cat([r.verify(X, y, w_full, b, scr_idx)
                              for r in verifying]).cpu().numpy()
        if len(viol) == 0:
            return res, w_full, b, rounds
        rounds += 1
        if rounds >= max_rounds:
            s_mask[:] = True  # give up screening this step: exact solve
        else:
            s_mask[np.unique(viol)] = True


def dynamic_tau(rules: Sequence[ScreeningRule]) -> float:
    """The in-solver screen's keep threshold for a rule mix: the smallest
    ``tau`` of the feature rules (a smaller tau keeps more), or
    :data:`~repro_torch.core.screening.SAFE_TAU` when none carries one."""
    taus = [float(r.tau) for r in rules
            if r.axis == AXIS_FEATURES and hasattr(r, "tau")]
    return min(taus) if taus else SAFE_TAU


RuleSpec = Union[None, str, ScreeningRule, Sequence[Union[str, ScreeningRule]]]


def make_rules(spec: RuleSpec) -> list[ScreeningRule]:
    """Normalize a rule spec into a flat list of rule instances: ``None`` /
    ``[]`` (no screening), a registry name, a rule instance, or a sequence
    of either. Containers (``"composite"``) are flattened through their
    ``subrules()``, so drivers see one rule per axis pass."""
    if spec is None:
        return []
    if isinstance(spec, (str, ScreeningRule)):
        spec = [spec]
    rules: list[ScreeningRule] = []
    for item in spec:
        rule = get_rule(item) if isinstance(item, str) else item
        sub = getattr(rule, "subrules", None)
        rules.extend(sub() if sub is not None else [rule])
    return rules
