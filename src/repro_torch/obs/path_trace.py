"""``PathTrace`` — the uniform per-step observability artifact.

A copy of the reference ``obs/path_trace.py``. Every path engine of the
port (host, host on a grid, scan, batched, sharded scan, chunked) attaches
one ``PathTrace`` to its result (``PathResult.extras["path_trace"]``): the
same schema of per-step records regardless of how the engine executes.

The host engines fill the records live (each step's walls are measured on
the host); the on-device engines build them after the path from the
outputs they return (``ScanPathOutputs``: kept, n_iters, gap, delta,
health per step) and their per-step solve seconds. Their steps overlap on
the device, so a step's wall is the uniform share of the path's and
``walls_observed`` is False.

See :class:`PathStep` for the field reference (also reproduced in the
``repro_torch.obs`` package docstring).
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field

import numpy as np

from . import trace as _trace

__all__ = ["PathStep", "PathTrace", "build_path_trace"]

NAN = float("nan")


@dataclass
class PathStep:
    """One lambda step of a screened path, engine-agnostic.

    Fields (``nan``/0 where an engine cannot observe the quantity):

    - ``step``: lambda-grid index ``k``.
    - ``lam``: the regularization value solved at this step.
    - ``kept``: feature count fed to the solver after screening.
    - ``kept_samples``: sample count fed to the solver (0 = axis unused).
    - ``active``: nnz(w) at the accepted solution.
    - ``iters``: FISTA iterations spent.
    - ``gap``: duality gap certified at the accepted point (``nan`` on the
      host engine, which certifies via the theta-radius only).
    - ``delta``: certified ``||theta1 - theta*||`` radius anchoring the
      next step's screen (``nan`` where not carried).
    - ``health``: guard-telemetry word (``HEALTH_SCREEN_REFUSED`` flags a
      fail-safe keep-all step; low bits count solver rollbacks).
    - ``wall_s``: total step wall seconds (host-measured, or the uniform
      share of a single-dispatch total — see ``PathTrace.walls_observed``).
    - ``screen_s`` / ``solve_s`` / ``certify_s``: the step's phase walls
      (host engines only; ``nan`` when unobservable).
    """

    step: int
    lam: float
    kept: int
    kept_samples: int
    active: int
    iters: int
    gap: float
    delta: float
    health: int
    wall_s: float
    screen_s: float = NAN
    solve_s: float = NAN
    certify_s: float = NAN


@dataclass
class PathTrace:
    """Per-run schema: engine tag, per-step records, and run totals.

    ``total_s`` is the one latency field every engine populates — the
    host driver sums its measured step walls, the server stamps the job's
    submit-to-done latency (previously only ``extras["latency_s"]``), and
    the single-dispatch engines use the blocked dispatch wall — so
    cross-engine latency comparisons read one field.
    """

    engine: str
    steps: list
    total_s: float
    walls_observed: bool
    meta: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "engine": self.engine,
            "total_s": self.total_s,
            "walls_observed": self.walls_observed,
            "meta": dict(self.meta),
            "steps": [asdict(s) for s in self.steps],
        }

    # -- trace synthesis ---------------------------------------------------

    def to_chrome_events(self, end_s: float, tid: int = 0) -> list:
        """Complete ('X') trace events laying the steps out on a timeline
        ending at ``end_s`` (seconds relative to the consumer's epoch) —
        the post-hoc span synthesis for engines with no live host loop.
        Phase walls, when observed, become child events nested inside each
        step's interval."""
        walls = [s.wall_s for s in self.steps]
        start = end_s - sum(walls)
        events = []
        t = start
        for s in self.steps:
            args = {"lam": s.lam, "kept": s.kept, "active": s.active,
                    "iters": s.iters, "health": s.health}
            if not math.isnan(s.gap):
                args["gap"] = s.gap
            events.append({
                "name": f"{self.engine}.step", "ph": "X",
                "ts": t * 1e6, "dur": s.wall_s * 1e6,
                "tid": tid, "args": args,
            })
            tp = t
            for phase in ("screen", "solve", "certify"):
                dur = getattr(s, f"{phase}_s")
                if not math.isnan(dur):
                    events.append({
                        "name": f"{self.engine}.{phase}", "ph": "X",
                        "ts": tp * 1e6, "dur": dur * 1e6,
                        "tid": tid, "args": {"step": s.step},
                    })
                    tp += dur
            t += s.wall_s
        return events

    def emit_to_tracer(self, tracer=None):
        """Append this trace's synthesized spans to the (enabled) process
        tracer so ``--trace out.json`` exports contain per-step spans from
        every engine, live-recorded or not."""
        tracer = tracer or _trace.get_tracer()
        if not tracer.enabled:
            return
        for ev in self.to_chrome_events(end_s=tracer.now()):
            tracer._append(ev)


def _col(x, k, default=NAN):
    if x is None:
        return default
    v = x[k]
    return float(v) if isinstance(default, float) else int(v)


def build_path_trace(
    engine: str,
    lambdas,
    kept,
    kept_samples,
    active,
    iters,
    wall,
    *,
    gaps=None,
    deltas=None,
    health=None,
    screen_s=None,
    solve_s=None,
    certify_s=None,
    total_s=None,
    walls_observed: bool = True,
    meta: dict | None = None,
) -> PathTrace:
    """Assemble a :class:`PathTrace` from per-step arrays (host-measured
    or device-streamed — the one constructor all engines share)."""
    lambdas = np.asarray(lambdas)
    T = len(lambdas)
    steps = [
        PathStep(
            step=k,
            lam=float(lambdas[k]),
            kept=_col(kept, k, 0),
            kept_samples=_col(kept_samples, k, 0),
            active=_col(active, k, 0),
            iters=_col(iters, k, 0),
            gap=_col(gaps, k),
            delta=_col(deltas, k),
            health=_col(health, k, 0),
            wall_s=_col(wall, k),
            screen_s=_col(screen_s, k),
            solve_s=_col(solve_s, k),
            certify_s=_col(certify_s, k),
        )
        for k in range(T)
    ]
    if total_s is None:
        total_s = float(np.sum(np.asarray(wall, np.float64)))
    return PathTrace(engine=engine, steps=steps, total_s=float(total_s),
                     walls_observed=bool(walls_observed),
                     meta=dict(meta or {}))
