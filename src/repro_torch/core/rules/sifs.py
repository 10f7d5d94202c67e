"""SIFS rule: simultaneous feature and sample reduction, alternated per step.

Port of the reference ``core/rules/sifs.py``. Zhang et al. ("Scaling Up
Sparse SVM by Simultaneous Feature and Sample Reduction") interleave a
feature screen and a sample screen, each tightening the other's region.
For the squared hinge with a pure L1 penalty the provable halves are the
EDPP feature screen (:mod:`.edpp`) and the margin-certified sample screen
with a-posteriori verification (:mod:`.sample_vi`): the alternation runs
through ``PathDriver``'s verification loop (feature mask, sample mask, reduced
solve, violators re-admitted, re-solve), each round one alternation, with
the certificate exact at the accepted solution.

A container, as :class:`~.composite.CompositeRule`: ``make_rules("sifs")``
flattens it to ``[EDPPRule, SampleVIRule]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..screening import SAFE_TAU
from .base import ScreeningRule, register_rule
from .edpp import EDPPRule
from .sample_vi import SampleVIRule

__all__ = ["SIFSRule"]


@register_rule("sifs")
class SIFSRule(ScreeningRule):
    """Container: the EDPP feature screen and the verified sample screen."""

    axis = "both"

    def __init__(self, tau: float = SAFE_TAU,
                 rules: Optional[Sequence[ScreeningRule]] = None):
        self.rules: list[ScreeningRule] = (
            list(rules) if rules is not None
            else [EDPPRule(tau=tau), SampleVIRule()])

    def subrules(self) -> list[ScreeningRule]:
        return list(self.rules)
