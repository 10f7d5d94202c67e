"""Path observability: trace spans, metrics, logging, PathTrace.

Port of the reference ``obs`` package (stdlib and numpy only; a copy, since
the port imports nothing of the reference). The engines of the port (host,
scan, batched, sharded scan, chunked) report through it, under the
reference's names:

- :mod:`repro_torch.obs.trace` — a low-overhead span recorder
  (``span("solve", step=k)`` context manager + instant events, no-op when
  disabled, thread-safe) exporting Chrome trace-event JSON loadable in
  Perfetto. ``PathDriver.run`` and ``_run_chunked`` record the
  ``path.screen`` / ``path.solve`` / ``path.certify`` / ``path.step`` spans
  from the ``perf_counter`` stamps they take anyway; the streamed solver
  and ``screen_step_stream`` record ``stream.solve`` / ``stream.screen``.
  Enable with ``REPRO_TRACE=1`` or ``train_svm --trace out.json``.
- :mod:`repro_torch.obs.metrics` — a process-wide registry of counters /
  gauges / histograms (``path.steps``, ``path.guard_trips``, ``path.kept``,
  the ``stream.*`` counters mirroring ``FeatureChunked.stats``) with JSON
  and Prometheus-text dumps.
- :mod:`repro_torch.obs.log` — logging setup (module-level loggers, one
  handler on the ``repro_torch`` root, ``REPRO_LOG_LEVEL`` env-tunable).
- :mod:`repro_torch.obs.path_trace` — the uniform ``PathTrace`` artifact
  every engine attaches at ``PathResult.extras["path_trace"]``.

PathTrace field reference (per step; ``nan`` where an engine cannot
observe the quantity):

====================  ====================================================
field                 meaning
====================  ====================================================
``step``              lambda-grid index ``k``
``lam``               regularization value solved at this step
``kept``              features fed to the solver after screening
``kept_samples``      samples fed to the solver (0 = axis unused)
``active``            nnz(w) at the accepted solution
``iters``             FISTA iterations spent
``gap``               duality gap certified at the accepted point
``delta``             certified theta-radius anchoring the next screen
``health``            guard word (``HEALTH_SCREEN_REFUSED`` = keep-all)
``wall_s``            step wall seconds (measured, or uniform share of a
                      single-dispatch total — ``walls_observed`` says
                      which)
``screen_s``          host-measured screening wall (host engines)
``solve_s``           host-measured solve wall (host engines)
``certify_s``         host-measured certification wall (host engines)
====================  ====================================================

Run-level: ``engine`` (host / host_sharded / scan / batched /
scan_sharded / chunked), ``total_s`` (the shared latency field: the host
driver's summed step walls, the single-dispatch engines' path wall),
``walls_observed``, and free-form ``meta`` (jid, stream stats, ...).
"""

from .log import get_logger, setup
from .metrics import (
    REGISTRY,
    MetricsRegistry,
    absorb,
    counter,
    gauge,
    histogram,
    snapshot,
    to_json,
    to_prometheus,
)
from .path_trace import PathStep, PathTrace, build_path_trace
from .trace import (
    Tracer,
    complete,
    enable,
    enabled,
    disable,
    export_chrome,
    get_tracer,
    instant,
    span,
)

__all__ = [
    "get_logger",
    "setup",
    "REGISTRY",
    "MetricsRegistry",
    "absorb",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "to_json",
    "to_prometheus",
    "PathStep",
    "PathTrace",
    "build_path_trace",
    "Tracer",
    "complete",
    "enable",
    "enabled",
    "disable",
    "export_chrome",
    "get_tracer",
    "instant",
    "span",
]
