"""Paper core: safe screening for the L1-regularized L2-loss SVM (PyTorch).

Modules: ``dual`` (lambda_max, certificates), ``screening`` (the VI bound),
``solver`` (FISTA, static and dynamic, host- or device-decided),
``rules`` (the screening-rule registry), ``path`` (``svm_path`` /
``PathDriver``) and ``path_scan`` (the on-device engines). The names below are
imported on first access, not here, so that the kernel modules can import
``core.screening`` without pulling in the solver.
"""

import importlib

#: exported name -> submodule that defines it
_EXPORTS = {
    "svm_path": "path", "PathDriver": "path", "PathResult": "path",
    "default_lambda_grid": "path",
    "svm_path_scan": "path_scan", "svm_path_batched": "path_scan",
    "ScanPathOutputs": "path_scan", "compact_caps": "path_scan",
    "compact_caps_batched": "path_scan", "engine_cache_info": "path_scan",
    "clear_engine_cache": "path_scan",
    "fista_run": "solver", "fista_run_dynamic": "solver",
    "fista_solve": "solver", "fista_solve_dynamic": "solver",
    "FistaResult": "solver", "DynamicFistaResult": "solver",
    "gap_theta_delta": "solver", "lipschitz_estimate": "solver",
    "lambda_max": "dual", "safe_theta_and_delta": "dual",
    "screen": "screening", "SAFE_TAU": "screening",
    "ConvexRegion": "rules", "ScreeningRule": "rules", "FeatureVIRule": "rules",
    "DVIRule": "rules", "SampleVIRule": "rules", "CompositeRule": "rules",
    "EDPPRule": "rules", "AutoRule": "rules", "SIFSRule": "rules",
    "available_rules": "rules", "get_rule": "rules", "make_rules": "rules",
    "dynamic_tau": "rules", "PROGRAMS": "rules", "RuleProgram": "rules",
    "resolve_programs": "rules", "stack_bounds": "rules",
    "stack_needs_history": "rules",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
