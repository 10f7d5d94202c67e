"""Pluggable safe-screening rules: ``"feature_vi"``, ``"dvi"``, ``"edpp"``,
``"auto"``, ``"sample_vi"`` and the containers ``"composite"`` and
``"sifs"`` (both axes); :mod:`.programs` holds the feature rules' bounds as
plain functions of the region's stats (rule programs)."""

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
from .edpp import EDPPRule  # noqa: F401
from .sifs import SIFSRule  # noqa: F401
from .auto import AutoRule  # noqa: F401
from .programs import (  # noqa: F401
    PROGRAMS,
    RuleProgram,
    resolve_programs,
    stack_bounds,
    stack_needs_history,
)
