"""Simultaneous feature and sample reduction (port of the reference
``core/rules/composite.py``).

Feature screening shrinks the m-axis of the solver sweeps and sample
screening the n-axis, so a reduced problem costs ``kept_m * kept_n``. Both
rules read the same :class:`~repro_torch.core.rules.base.ConvexRegion`;
the driver applies them in turn (feature mask, then sample mask) and runs
the sample rule's verification loop on the combined reduction.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .base import ScreeningRule, register_rule
from .feature_vi import FeatureVIRule
from .sample_vi import SampleVIRule

__all__ = ["CompositeRule"]


@register_rule("composite")
class CompositeRule(ScreeningRule):
    """Container rule: ``make_rules`` flattens it, so ``rules="composite"``
    is ``rules=["feature_vi", "sample_vi"]``; custom mixtures pass
    instances, ``CompositeRule([FeatureVIRule(tau=...), ...])``."""

    axis = "both"

    def __init__(self, rules: Optional[Sequence[ScreeningRule]] = None):
        self.rules: list[ScreeningRule] = (
            list(rules) if rules is not None else [FeatureVIRule(), SampleVIRule()])

    def subrules(self) -> list[ScreeningRule]:
        return list(self.rules)
