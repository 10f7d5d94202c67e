"""Pluggable safe-screening rules. This slice registers ``"feature_vi"``."""

from .base import (  # noqa: F401
    AXIS_FEATURES,
    ConvexRegion,
    ScreeningRule,
    available_rules,
    get_rule,
    make_rules,
    register_rule,
)
from .feature_vi import FeatureVIRule  # noqa: F401
