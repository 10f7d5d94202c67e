"""Screening-rule protocol, the shared region, and the rule registry.

Port of the reference ``core/rules/base.py`` (dual side). A screening rule
inspects the region that contains the next path step's dual optimum and
certifies that some feature rows of ``X`` cannot be active there:

* ``axis``   — which axis of ``X`` it reduces;
* ``bounds`` — a per-unit score derived from the region;
* ``keep``   — which units survive, given those scores.

:class:`ConvexRegion` is built once per path step and shared by the rules.
Rules register under a short name (``@register_rule("feature_vi")``) so
drivers and the launcher are configured with strings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from ..screening import ScreenShared, shared_scalars

__all__ = [
    "ConvexRegion",
    "ScreeningRule",
    "register_rule",
    "get_rule",
    "available_rules",
    "make_rules",
    "AXIS_FEATURES",
]

AXIS_FEATURES = "features"


@dataclass(frozen=True)
class ConvexRegion:
    """The VI set for ``theta*(lam2)``: the anchor ``theta1`` at ``lam1`` with
    ``||theta1 - theta*(lam1)|| <= delta``, and ``shared``, the set's scalars
    (paper Sec. 6.4), delta-inflated so the set still contains
    ``theta*(lam2)`` under inexact solves. Tensors stay on the anchor's
    device."""

    y: torch.Tensor
    lam1: float
    lam2: float
    theta1: torch.Tensor
    delta: Union[float, torch.Tensor] = 0.0
    shared: Optional[ScreenShared] = None

    @classmethod
    def build(cls, y: torch.Tensor, lam1, lam2, theta1: torch.Tensor,
              delta=0.0) -> "ConvexRegion":
        sh = shared_scalars(y, lam1, lam2, theta1, delta=delta)
        return cls(y=y, lam1=float(lam1), lam2=float(lam2), theta1=theta1,
                   delta=delta, shared=sh)


class ScreeningRule:
    """Base class / protocol for screening rules.

    Subclasses set ``name`` and ``axis`` and implement ``bounds`` and
    ``keep``. The rules of this slice are a-priori safe: a rejected unit
    provably does not matter, so no verification pass follows.
    """

    name: str = "base"
    axis: str = AXIS_FEATURES

    def bounds(self, X: torch.Tensor, y: torch.Tensor,
               region: ConvexRegion) -> torch.Tensor:
        raise NotImplementedError

    def keep(self, bounds: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def screen(self, X, y, region) -> tuple[torch.Tensor, torch.Tensor]:
        b = self.bounds(X, y, region)
        return self.keep(b), b

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


RuleSpec = Union[None, str, ScreeningRule, Sequence[Union[str, ScreeningRule]]]


def make_rules(spec: RuleSpec) -> list[ScreeningRule]:
    """Normalize a rule spec into a flat list of rule instances: ``None`` /
    ``[]`` (no screening), a registry name, a rule instance, or a sequence
    of either."""
    if spec is None:
        return []
    if isinstance(spec, (str, ScreeningRule)):
        spec = [spec]
    return [get_rule(item) if isinstance(item, str) else item for item in spec]
