"""Pluggable safe-screening rules: ``"feature_vi"``, ``"dvi"``,
``"sample_vi"`` and the container ``"composite"`` (both axes)."""

from .base import (  # noqa: F401
    AXIS_FEATURES,
    AXIS_SAMPLES,
    ConvexRegion,
    ScreeningRule,
    available_rules,
    dynamic_tau,
    get_rule,
    make_rules,
    register_rule,
    solve_with_verification,
)
from .feature_vi import FeatureVIRule  # noqa: F401
from .dvi import DVIRule  # noqa: F401
from .sample_vi import SampleVIRule, sample_slack_caps  # noqa: F401
from .composite import CompositeRule  # noqa: F401
