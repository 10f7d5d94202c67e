"""Multi-tenant sparse-SVM path server: continuous batching of screened
paths (port of the reference ``launch/path_server.py``).

The paper's pitch is throughput: screening makes many solves (a lambda path
per tenant, a hyperparameter sweep, one model per dataset) cost far less
than their naive flops. This module is the serving front end for that
claim: a queue of :class:`PathJob` requests drains through a fixed number
of batch *slots*, every lambda step of every resident job runs as ONE
batched step (``core/path_scan._batched_path_step``: the shared-capacity
screen, solve and certificate of every slot), and a slot refills the moment
its job's grid is exhausted (continuous batching). A finished job's
:class:`~repro_torch.core.path.PathResult` is assembled from its streamed
steps, so no job waits on the batch.

Bucket and padding policy
-------------------------
Jobs are padded into power-of-two shape buckets (``core/path.py::_bucket``,
min 8): a job of true shape ``(m, n)`` occupies an ``(m_b, n_b)`` slot with
``m_b = bucket(m)``, ``n_b = bucket(n)``. The padding is safe by
construction:

* padded **feature rows** are zero, so their screen bound is 0 < tau and
  every step drops them; under ``reduce="compact"`` they cost nothing in
  the solve;
* padded **sample columns** carry a 0/1 sample mask that reaches the
  feature screen as its sample weights (its weighted instantiation, in the
  VI and the EDPP mode), the solver as its sample mask and the
  certificate, and ``n_tot`` is the live count, so each slot solves its
  true, unpadded problem.

The group's ``(B, m_b, n_b)`` slot buffer is allocated on the device once
per group; a job entering a slot zeroes the slot and copies its true X into
the corner, on the device, so a smaller job never sees the residue of a
larger one. Slots in one batch share a bucket, so a serve group is keyed by
``(m_b, n_b, rule_stack, dynamic)``, ``rule_stack`` the job's rule spec
resolved to a program tuple (any single-anchor stack: ``feature_vi``,
``edpp``, ``auto``, lists; ``()`` is screening off; ``dvi`` is rejected,
its anchor history cannot ride a slot carry that jobs splice in and out
of). The queue drains group by group.

The program cache
-----------------
The reference compiles one XLA program per key::

    (m_bucket, n_bucket, cap_bucket, B, engine_config)

``cap_bucket`` is the shared compact capacity predicted for the step from
the slots' observed keep counts (``compact_caps_batched``; ``m_bucket`` in
mask mode). Here the same key names a step whose FISTA chunks are captured
CUDA graphs (``core/solver.py``: cached by the matrix a chunk reads, so
compact steps share one graph per capacity and mask-mode steps capture one
per slot, each slot's ``X[e]`` having its own address). ``hits`` and
``misses`` count the keys; ``retraces`` counts re-captures of a graph key
that was already captured (the graph cache holds
``solver.GRAPH_CACHE_SIZE``): on a warm server it stays 0. A wrong
capacity prediction never breaks correctness: a step whose kept count
overflows it runs in mask mode. When a group's slot buffer is freed, the
graphs that read it are dropped with it (``solver.drop_graphs_reading``).

Fault tolerance
---------------
Each :class:`PathJob` carries an optional wall-clock ``deadline_s`` and a
``max_retries`` budget. After every batched step the server host-checks each
live slot's outputs for finiteness. A poisoned slot is rolled back to its
pre-step carry, sanitized (a non-finite certificate re-enters as a
*refusing* one, ``delta = inf``, so the retried step keeps every feature),
and retried with backoff; a slot out of retries (or past its deadline) is
quarantined: masked out of the batch, evicted with ``status="failed"``,
its slot state zeroed, while the other tenants' slots run on. The solver's
guard is always on in the port and heals a poisoned carry inside the solve,
so the tests poison a slot's step outputs through the
``PathServer._fault_injector(step, slot, outputs)`` seam, before the host
check (``testing/faults.poison_server_slot``).

``serve(..., snapshot_dir=...)`` checkpoints the whole serve state (the
slot buffers, every job's stream of steps, the queue's order) every
``snapshot_every`` steps through
:class:`~repro_torch.checkpoint.CheckpointManager`; serving the same job list
again with the same ``snapshot_dir`` after a crash resumes mid-path, with
results equal to an uninterrupted run's bit for bit.

Observability (``repro_torch.obs``, the reference's names): the
``serve.refill``, ``serve.step`` and ``serve.checkpoint`` spans, the
``serve.<key>`` counters mirroring :attr:`PathServer.stats`, the
``serve.latency_s`` histogram, the ``serve.slot_occupancy`` gauge, and each
result's ``path_trace`` (``engine="serve"``, ``jid``, ``latency_s``).

    PYTHONPATH=src python -m repro_torch.launch.path_server --jobs 6 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..core import solver
from ..core.dual import bias_at_lambda_max, lambda_max, theta_at_lambda_max
from ..core.path import PathResult, _bucket, _validate_grid, default_lambda_grid
from ..core.path_scan import (
    ScanPathOutputs,
    _batched_path_step,
    _batched_statics,
    _inv_L,
    _static_opts,
    _to_path_result,
    compact_caps_batched,
    engine_cache_info,
)
from ..core.rules.programs import PROGRAMS, resolve_programs
from ..core.screening import SAFE_TAU
from ..core.solver import host_fetch, lipschitz_estimate
from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.log import get_logger
from ..obs.log import setup as log_setup

__all__ = ["PathJob", "PathServer", "demo_jobs", "main"]

_LOG = get_logger("launch.path_server")

#: what a job records of each of its steps: the step's outputs and the
#: seconds its solve took
_STEP_FIELDS = ScanPathOutputs._fields + ("solve_s",)


@dataclass
class PathJob:
    """One tenant's path request: a dataset, a grid and rules. ``X`` (m, n)
    and ``y`` (n,) are numpy arrays or tensors (on any device)."""

    jid: int
    X: object                             # (m, n) feature-major design
    y: object                             # (n,) +-1 labels
    lambdas: Optional[np.ndarray] = None  # explicit decreasing grid, else:
    n_lambdas: int = 10
    lam_min_ratio: float = 0.1
    rules: str = "feature_vi"             # any single-anchor program stack
    dynamic: bool = False                 # in-solver re-screen segments
    deadline_s: Optional[float] = None    # wall budget from first insert
    max_retries: int = 1                  # poisoned-step retry budget

    # -- server-owned runtime state (streamed results) -----------------------
    t: int = field(default=0, repr=False)
    steps: list = field(default_factory=list, repr=False)
    result: Optional[PathResult] = field(default=None, repr=False)
    lam_max: float = field(default=0.0, repr=False)
    t_submit: float = field(default=0.0, repr=False)
    t_done: float = field(default=0.0, repr=False)
    t_start: float = field(default=0.0, repr=False)  # deadline epoch
    retries: int = field(default=0, repr=False)
    status: str = field(default="queued", repr=False)  # running/done/failed
    error: Optional[str] = field(default=None, repr=False)

    @property
    def rule_stack(self) -> tuple:
        """The job's rule spec resolved to a program tuple. Raises for
        sample rules and rules that need verification (the server runs the
        batched scan step, as ``engine="scan"``) and for two-anchor programs
        such as ``dvi``: the slot carry holds one anchor, and jobs splice in
        and out of slots mid-path, so anchor history cannot ride it."""
        progs = resolve_programs(self.rules, screening=True)
        deep = [nm for nm in progs if PROGRAMS[nm].n_anchors > 1]
        if deep:
            raise ValueError(
                f"the path server's slot carry holds a single anchor; "
                f"rules needing anchor history {deep} are not servable — "
                f"run {self.rules!r} through engine='scan' or the host "
                f"engine (PathDriver) instead")
        return progs

    @property
    def screening(self) -> bool:
        return bool(self.rule_stack)

    def group_key(self) -> tuple:
        """Jobs sharing this key can occupy slots of the same batch."""
        m, n = self.X.shape
        return (_bucket(m), _bucket(n), self.rule_stack, bool(self.dynamic))


def _with_slot(tensors: tuple, slot: int, values) -> tuple:
    """Copies of ``tensors`` with row ``slot`` of each set to its value. A
    copy, never an in-place write: the pre-step carry a rollback restores
    must not change under the step that follows it."""
    out = []
    for t, v in zip(tensors, values, strict=True):
        t = t.clone()
        t[slot] = v
        out.append(t)
    return tuple(out)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with ``t`` (on the CPU ``.cpu()``
    is ``t`` itself, and a later write to the slot state would show in
    every step a job recorded)."""
    return t.detach().cpu().numpy().copy()


class PathServer:
    """Continuous-batching front end over the batched scan-engine step.

    ``slots`` is the batch width B of every step; see the module docstring
    for the bucket policy and the cache key. ``reduce="compact"`` (default)
    predicts a shared compact capacity per step from the observed keep
    counts; ``reduce="mask"`` always solves at the bucket's full width.
    Runs on ``device``, by default the GPU (the kernels always run on the
    card; the CPU runs their plain versions). ``dtype``: the slot
    buffers'."""

    def __init__(self, slots: int = 4, *, reduce: str = "compact",
                 tau: float = SAFE_TAU, tol: float = 1e-9,
                 max_iters: int = 4000, screen_every: int = 50,
                 cap_growth: float = 1.5, dtype=torch.float32, device="cuda"):
        if reduce not in ("mask", "compact"):
            raise ValueError(f"reduce must be 'mask' or 'compact', got {reduce!r}")
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.reduce = reduce
        self.tau = float(tau)
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.screen_every = int(screen_every)
        self.cap_growth = float(cap_growth)
        self.dtype = dtype

        self._program_keys: set = set()
        self.stats = dict(hits=0, misses=0, steps=0, occupied_slots=0,
                          jobs_done=0, mask_fallback_steps=0,
                          retries=0, jobs_failed=0)
        self._graphs0 = dict(solver.GRAPHS)
        self._group: Optional[tuple] = None
        self._X = None
        self._act = np.zeros((self.slots,), bool)
        self._slot_jobs: list[Optional[PathJob]] = [None] * self.slots
        # testing seams: hook(step_count) after every serve-loop step (after
        # the snapshot; raising simulates a crash mid-drain), and
        # injector(step_count, slot, outputs) -> outputs on each live slot's
        # host outputs before the finiteness check
        self._step_hook = None
        self._fault_injector = None
        self._retry_backoff_s = 0.01
        # jobs finished (done or failed) this serve: a snapshot carries their
        # streams too, or a resume would lose their results
        self._tracked_done: list[PathJob] = []

    def _bump(self, key: str, n: int = 1):
        """Increment a ``stats`` counter and mirror it into the process-wide
        metrics registry under ``serve.<key>``."""
        self.stats[key] += n
        obs_metrics.counter("serve." + key).inc(n)

    # -- program cache ------------------------------------------------------

    def _count_program(self, m_b: int, n_b: int, cap_b: int, cfg: tuple):
        """Count the step's program key as a hit or a miss. The step itself
        needs no cached object: its chunk graphs live in the solver's graph
        cache, keyed by the slot's address and shape."""
        key = (m_b, n_b, cap_b, self.slots, cfg)
        self._bump("hits" if key in self._program_keys else "misses")
        self._program_keys.add(key)

    def cache_stats(self) -> dict:
        """Warm-cache health: step programs (keys), hits and misses, graph
        re-captures (``retraces``), and the chunk graphs captured and
        replayed since this server was made."""
        g = {k: solver.GRAPHS[k] - self._graphs0[k] for k in solver.GRAPHS}
        return dict(programs=len(self._program_keys), hits=self.stats["hits"],
                    misses=self.stats["misses"], retraces=g["recaptures"],
                    graph_captures=g["captures"], graph_replays=g["replays"])

    def metrics(self) -> dict:
        """The process-wide :mod:`repro_torch.obs.metrics` snapshot (the
        server's counters mirror into it live), with :meth:`cache_stats`
        and the engines' graph cache absorbed as gauges."""
        obs_metrics.absorb("serve.cache", self.cache_stats())
        obs_metrics.gauge("engine.cache.programs").set(len(engine_cache_info()))
        obs_metrics.gauge("engine.cache.retraces").set(solver.GRAPHS["recaptures"])
        return obs_metrics.snapshot()

    # -- group (bucket) state -----------------------------------------------

    def _cfg_for(self, group: tuple) -> tuple:
        _, _, rule_stack, dynamic = group
        # the resolved program tuple resolves again to itself
        return _static_opts(self.max_iters, bool(rule_stack), dynamic,
                            self.screen_every, False, self.reduce,
                            list(rule_stack) if rule_stack else "none")

    def _alloc_group(self, group: tuple):
        """(Re)allocate the device slot state for a new bucket group; the
        graphs that read the old slot buffer go with it."""
        m_b, n_b, _, _ = group
        B, dev, dt = self.slots, self.device, self.dtype
        if self._X is not None:
            solver.drop_graphs_reading(self._X)
            self._X = None
        self._group = group
        self._cfg = self._cfg_for(group)
        # the step takes the options without `reduce`: the reduction is the
        # caps tuple of the program key
        self._step_cfg = tuple(kv for kv in self._cfg if kv[0] != "reduce")

        def z(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        self._X = z(B, m_b, n_b)
        self._y = z(B, n_b)
        self._sm = z(B, n_b)
        self._statics = (z(B), z(B))  # (one_y, n_tot) of each slot
        self._inv_L = torch.ones((B,), dtype=torch.float32, device=dev)
        self._carry = (z(B, m_b), z(B), z(B, n_b), z(B), z(B) + 1, z(B, m_b) + 1)
        self._lam_host = np.ones((B,), np.float64)
        self._last_kept = np.zeros((B,), np.int64)
        self._act[:] = False
        self._slot_jobs = [None] * B

    def _insert(self, slot: int, job: PathJob):
        """Pad the job into its bucket on the device: zero the slot, copy the
        true X, y and live-sample mask into its corner, then the slot's
        statics, step and anchor at lambda_max."""
        m_b, n_b, _, _ = self._group
        dev, dt = self.device, self.dtype
        X = torch.as_tensor(job.X).to(device=dev, dtype=dt)
        y = torch.as_tensor(job.y).to(device=dev, dtype=dt)
        m, n = X.shape
        # the anchor from the true arrays, as the scan engines compute it
        lam_max_t = lambda_max(X, y)
        job.lam_max = float(host_fetch(lam_max_t, "setup"))
        if job.lambdas is None:
            job.lambdas = default_lambda_grid(job.lam_max, job.n_lambdas,
                                              job.lam_min_ratio)
        job.lambdas = _validate_grid(job.lambdas)
        lam0 = lam_max_t.to(dt)
        theta0 = torch.zeros((n_b,), dtype=dt, device=dev)
        theta0[:n] = theta_at_lambda_max(y, lam0)

        Xs, ys, sms = self._X[slot], self._y[slot], self._sm[slot]
        Xs.zero_()
        Xs[:m, :n].copy_(X)
        ys.zero_()
        ys[:n].copy_(y)
        sms.zero_()
        sms[:n] = 1.0
        # padded rows and columns are zero: sigma_max is the true problem's
        inv_L = _inv_L(lipschitz_estimate(Xs))
        self._statics = _with_slot(self._statics, slot,
                                   _batched_statics(None, ys, sms, True))
        (self._inv_L,) = _with_slot((self._inv_L,), slot, (inv_L,))
        self._carry = _with_slot(self._carry, slot, (
            0.0, bias_at_lambda_max(y), theta0, 0.0, lam0, 1.0))
        self._lam_host[slot] = job.lam_max
        self._last_kept[slot] = 0
        self._act[slot] = True
        self._slot_jobs[slot] = job
        job.status = "running"
        if job.t_start == 0.0:
            job.t_start = time.perf_counter()

    # -- one batched lambda step --------------------------------------------

    def _predict_cap(self, m_b: int) -> int:
        """The shared capacity of the next step from the observed keep
        counts: the last count times ``cap_growth`` (keeps grow as lambda
        falls); a fresh slot (nothing observed) predicts the smallest
        bucket, as its first step past lambda_max keeps almost nothing. A
        wrong prediction costs speed, never correctness (the step's
        overflow runs in mask mode)."""
        if self.reduce != "compact":
            return m_b
        pred = [max(1, int(np.ceil(self._last_kept[s] * self.cap_growth)))
                for s in range(self.slots) if self._act[s]]
        return int(compact_caps_batched(m_b, pred or [1]))

    def step(self):
        m_b, n_b, _, _ = self._group
        now = time.perf_counter()
        for s in range(self.slots):
            job = self._slot_jobs[s]
            if not self._act[s]:
                continue
            if job.deadline_s is not None and now - job.t_start > job.deadline_s:
                self._evict_failed(s, f"deadline {job.deadline_s}s exceeded at "
                                      f"lambda index {job.t}")
                continue
            self._lam_host[s] = float(job.lambdas[job.t])
        if not self._act.any():
            return
        cap_b = self._predict_cap(m_b)
        self._count_program(m_b, n_b, cap_b, self._step_cfg)
        lam = torch.as_tensor(self._lam_host, dtype=self.dtype).to(self.device)
        carry_prev = self._carry
        tele: dict = {}
        self._carry, out = _batched_path_step(
            self._X, self._y, self._sm, self._statics, self._inv_L, self.tau, self.tol,
            carry_prev, lam, self._act.copy(), caps=() if cap_b >= m_b else (cap_b,),
            shared_x=False, telemetry=tele,
            **dict(self._step_cfg))
        host = {k: _host(v) for k, v in out._asdict().items()}
        host["solve_s"] = np.asarray(tele["solve_seconds"][0], np.float64)
        self._bump("steps")
        self._bump("occupied_slots", int(self._act.sum()))
        if self.reduce == "compact" and int(host["cap"][0]) >= m_b:
            self._bump("mask_fallback_steps")
        for s in range(self.slots):
            if not self._act[s]:
                continue
            job = self._slot_jobs[s]
            rec = {k: v[s] for k, v in host.items()}
            if self._fault_injector is not None:
                rec = self._fault_injector(self.stats["steps"], s, rec)
            if not (np.isfinite(rec["obj"]) and np.all(np.isfinite(rec["w"]))):
                # this slot rolls back to its pre-step carry (sanitized: a
                # poisoned certificate re-enters refusing) and the step is
                # not recorded; the other tenants' outputs are committed
                if job.retries < job.max_retries:
                    job.retries += 1
                    self._bump("retries")
                    time.sleep(self._retry_backoff_s * (2 ** (job.retries - 1)))
                    self._carry = self._restore_slot_carry(carry_prev, s)
                    continue
                self._evict_failed(s, f"non-finite step output at lambda index "
                                      f"{job.t} after {job.retries} retries")
                continue
            job.steps.append(rec)
            self._last_kept[s] = int(rec["kept"])
            job.t += 1
            if job.t >= len(job.lambdas):
                self._finish(s)

    def _restore_slot_carry(self, carry_prev, s: int) -> tuple:
        """Slot ``s``'s pre-step carry spliced back in, sanitized: non-finite
        weights, bias and theta become zeros (always feasible), a non-finite
        ``delta`` becomes ``+inf`` (a refusing certificate: the retried step
        keeps every feature), a non-finite lambda the step's own, and a
        non-finite keep flag live."""
        pw, pb, pth, pdl, plp, pkm = (c[s] for c in carry_prev)

        def where_finite(a, other):
            return torch.where(torch.isfinite(a), a, torch.full_like(a, other))

        return _with_slot(self._carry, s, (
            where_finite(pw, 0.0), where_finite(pb, 0.0), where_finite(pth, 0.0),
            where_finite(pdl, float("inf")), where_finite(plp, self._lam_host[s]),
            where_finite(pkm, 1.0)))

    def _evict_failed(self, slot: int, msg: str):
        """Quarantine a poisoned or overdue job: mask its slot out of the
        batch, zero the slot's carry (no NaN residue for the next tenant)
        and evict it with ``status="failed"``; results stay one per job (a
        failed job's ``result`` is None, its ``error`` says why)."""
        job = self._slot_jobs[slot]
        job.status = "failed"
        job.error = msg
        job.t_done = time.perf_counter()
        job.result = None
        self._bump("jobs_failed")
        obs_metrics.histogram("serve.latency_s").observe(float(job.t_done - job.t_submit))
        self._tracked_done.append(job)
        self._act[slot] = False
        self._slot_jobs[slot] = None
        self._carry = _with_slot(self._carry, slot, [0.0] * len(self._carry))

    def _assemble(self, job: PathJob) -> PathResult:
        """The job's PathResult from its streamed steps (also how a resume
        rebuilds the finished jobs), trimmed to its true shape."""
        m = job.X.shape[0]
        stacked = {k: np.stack([st[k] for st in job.steps]) for k in _STEP_FIELDS}
        stacked["w"] = stacked["w"][:, :m]
        stacked["fmask"] = stacked["fmask"][:, :m]
        # mask-mode steps report the bucket's width: clamp to the true m
        stacked["cap"] = np.minimum(stacked["cap"], m)
        solve_s = stacked.pop("solve_s")
        latency = job.t_done - job.t_submit
        r = _to_path_result(job.lambdas, ScanPathOutputs(**stacked), job.lam_max,
                            latency, self._cfg_for(job.group_key()), "serve",
                            {"solve_seconds": solve_s})
        r.extras["jid"] = job.jid
        r.extras["latency_s"] = latency
        # the shared PathTrace latency field: the job's queue-to-done wall
        pt = r.extras["path_trace"]
        pt.meta["jid"] = job.jid
        pt.meta["latency_s"] = float(latency)
        pt.emit_to_tracer()
        job.result = r
        return r

    def _finish(self, slot: int):
        job = self._slot_jobs[slot]
        job.t_done = time.perf_counter()
        self._assemble(job)
        job.status = "done"
        self._bump("jobs_done")
        obs_metrics.histogram("serve.latency_s").observe(float(job.t_done - job.t_submit))
        self._tracked_done.append(job)
        self._act[slot] = False
        self._slot_jobs[slot] = None

    # -- snapshot / resume --------------------------------------------------

    def _snapshot(self, mgr: CheckpointManager, pending: list):
        """Checkpoint the whole serve state at the current step count: the
        slot buffers, each job's stacked step stream and grid in the npz;
        the group key, the slot-to-job map, the queue's order and each job's
        progress in the manifest. The write is atomic."""
        now = time.perf_counter()
        flat = {"X": self._X, "y": self._y, "sm": self._sm, "inv_L": self._inv_L,
                "lam_host": self._lam_host, "last_kept": self._last_kept,
                "act": self._act}
        for i, a in enumerate(self._statics):
            flat[f"statics{i}"] = a
        for i, a in enumerate(self._carry):
            flat[f"carry{i}"] = a
        jobs_meta = {}
        tracked = [j for j in self._slot_jobs if j is not None]
        tracked += list(pending) + list(self._tracked_done)
        for job in tracked:
            jid = int(job.jid)
            jobs_meta[str(jid)] = {
                "t": int(job.t), "retries": int(job.retries),
                "status": job.status, "error": job.error,
                "lam_max": float(job.lam_max),
                "elapsed": float(now - job.t_submit),
                "started": float(now - job.t_start) if job.t_start else -1.0,
                "n_steps": len(job.steps),
            }
            if job.lambdas is not None:
                flat[f"job{jid}_lambdas"] = np.asarray(job.lambdas)
            if job.steps:
                for f in _STEP_FIELDS:
                    flat[f"job{jid}_{f}"] = np.stack([st[f] for st in job.steps])
        m_b, n_b, rule_stack, dynamic = self._group
        extra = {
            "group": [int(m_b), int(n_b), list(rule_stack), bool(dynamic)],
            "slots": [int(j.jid) if j is not None else -1 for j in self._slot_jobs],
            "pending": [int(j.jid) for j in pending],
            "jobs": jobs_meta,
            "stats": {k: int(v) for k, v in self.stats.items()},
        }
        mgr.save(self.stats["steps"], flat, extra=extra)

    def _restore_serve(self, mgr: CheckpointManager, jobs: list) -> Optional[list]:
        """Resume from the latest snapshot: rebuild the slot state on the
        device, splice each job's recorded progress back (matched by
        ``jid``) and return the restored queue; None without a valid
        snapshot (a fresh serve)."""
        step = mgr.latest()
        if step is None:
            return None
        flat, manifest = mgr.restore_raw(step)
        ex = manifest["extra"]
        by_jid = {int(j.jid): j for j in jobs}
        g = ex["group"]
        self._alloc_group((int(g[0]), int(g[1]), tuple(g[2]), bool(g[3])))

        def dev(a, like):
            return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)

        for name in ("X", "y", "sm"):
            getattr(self, f"_{name}").copy_(dev(flat[name], getattr(self, f"_{name}")))
        self._inv_L = dev(flat["inv_L"], self._inv_L)
        self._statics = tuple(dev(flat[f"statics{i}"], t)
                              for i, t in enumerate(self._statics))
        self._carry = tuple(dev(flat[f"carry{i}"], t) for i, t in enumerate(self._carry))
        self._lam_host = np.asarray(flat["lam_host"], np.float64).copy()
        self._last_kept = np.asarray(flat["last_kept"], np.int64).copy()
        self._act = np.asarray(flat["act"], bool).copy()
        now = time.perf_counter()
        self._tracked_done = []
        for jid_s, jm in ex["jobs"].items():
            job = by_jid.get(int(jid_s))
            if job is None:
                raise ValueError(f"snapshot references job {jid_s} missing from "
                                 f"the resubmitted job list")
            job.t = int(jm["t"])
            job.retries = int(jm["retries"])
            job.status = jm["status"]
            job.error = jm["error"]
            job.lam_max = float(jm["lam_max"])
            job.t_submit = now - float(jm["elapsed"])
            job.t_start = now - float(jm["started"]) if jm["started"] >= 0 else 0.0
            key = f"job{int(jid_s)}_lambdas"
            if key in flat:
                job.lambdas = np.asarray(flat[key])
            n_steps = int(jm["n_steps"])
            job.steps = [{f: flat[f"job{int(jid_s)}_{f}"][k] for f in _STEP_FIELDS}
                         for k in range(n_steps)]
            if job.status == "done":
                job.t_done = job.t_submit + float(jm["elapsed"])
                self._assemble(job)
                self._tracked_done.append(job)
                self._bump("jobs_done")
            elif job.status == "failed":
                job.t_done = job.t_submit + float(jm["elapsed"])
                self._tracked_done.append(job)
                self._bump("jobs_failed")
        self._slot_jobs = [by_jid[j] if j >= 0 else None for j in ex["slots"]]
        # restoring sets `stats`; the registry counter takes the difference,
        # so the two stay equal
        restored = int(ex["stats"].get("steps", manifest["step"]))
        self._bump("steps", restored - self.stats["steps"])
        return [by_jid[j] for j in ex["pending"]]

    # -- the serve loop -----------------------------------------------------

    def serve(self, jobs: list[PathJob], log=None, snapshot_dir=None,
              snapshot_every: int = 0) -> list[Optional[PathResult]]:
        """Drain a job queue; returns the results in submission order (a
        failed job's entry is None, its ``.error`` says why).

        Continuous batching: empty slots refill from the queue (same bucket
        group) before every step, so ragged grid lengths keep the slots
        busy rather than waiting on the longest path. ``snapshot_dir``:
        the serve state is checkpointed there every ``snapshot_every``
        steps; serving the same ``jobs`` (matched by ``jid``) with the same
        ``snapshot_dir`` again resumes from the latest snapshot, and the
        resumed results equal an uninterrupted run's."""
        if log is None:
            log = _LOG.info
        pending = list(jobs)
        t0 = time.perf_counter()
        for j in pending:
            j.t_submit = t0
        mgr = CheckpointManager(snapshot_dir, keep=2) if snapshot_dir is not None else None
        resumed = self._restore_serve(mgr, jobs) if mgr is not None else None
        if resumed is not None:
            pending = resumed
        else:
            self._tracked_done = []
        while pending or self._act.any():
            if not self._act.any():
                nxt_group = pending[0].group_key()
                if self._group != nxt_group:
                    self._alloc_group(nxt_group)
            with obs_trace.span("serve.refill", pending=len(pending)):
                for s in range(self.slots):
                    if not self._act[s]:
                        nxt = next((j for j in pending
                                    if j.group_key() == self._group), None)
                        if nxt is None:
                            break
                        pending.remove(nxt)
                        self._insert(s, nxt)
            with obs_trace.span("serve.step", step=self.stats["steps"],
                                occupied=int(self._act.sum())):
                self.step()
            if (mgr is not None and snapshot_every
                    and self.stats["steps"] % int(snapshot_every) == 0):
                with obs_trace.span("serve.checkpoint", step=self.stats["steps"]):
                    self._snapshot(mgr, pending)
            if self._step_hook is not None:
                self._step_hook(self.stats["steps"])
        wall = time.perf_counter() - t0
        lat = np.array([j.t_done - j.t_submit for j in jobs])
        occ = self.stats["occupied_slots"] / max(1, self.stats["steps"] * self.slots)
        self.last_serve = dict(
            jobs=len(jobs), wall_s=float(wall), jobs_per_s=len(jobs) / wall,
            steps=self.stats["steps"], slot_occupancy=float(occ),
            latency_p50_s=float(np.percentile(lat, 50)),
            latency_p95_s=float(np.percentile(lat, 95)),
            **self.cache_stats())
        obs_metrics.gauge("serve.slot_occupancy").set(float(occ))
        log(f"[serve] {len(jobs)} jobs in {wall:.2f}s "
            f"({self.last_serve['jobs_per_s']:.2f} jobs/s), "
            f"occupancy={occ:.2f}, cache={self.cache_stats()}")
        return [j.result for j in jobs]


def demo_jobs(n_jobs: int = 8, m: int = 300, n: int = 120, seed: int = 0,
              ragged: bool = True) -> list[PathJob]:
    """A mixed-grid workload over independent synthetic problems (the
    reference's: the same arrays and grids for the same arguments)."""
    from ..data import make_sparse_classification

    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n_jobs):
        ds = make_sparse_classification(m=m, n=n, k_active=10, seed=seed + i)
        T = int(rng.integers(4, 10)) if ragged else 8
        jobs.append(PathJob(jid=i, X=ds.X, y=ds.y, n_lambdas=T,
                            lam_min_ratio=float(rng.uniform(0.1, 0.3))))
    return jobs


def write_artifacts(server: PathServer) -> None:
    """``artifacts/svm_serve.json`` (the last serve's summary) and
    ``artifacts/svm_serve_metrics.json`` (:meth:`PathServer.metrics`) under
    the working directory."""
    Path("artifacts").mkdir(exist_ok=True)
    Path("artifacts/svm_serve.json").write_text(json.dumps(server.last_serve, indent=2))
    Path("artifacts/svm_serve_metrics.json").write_text(
        json.dumps(server.metrics(), indent=2, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--m", type=int, default=300)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--reduce", choices=("mask", "compact"), default="compact")
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    log_setup()
    server = PathServer(slots=args.slots, reduce=args.reduce, tol=args.tol,
                        device=args.device)
    results = server.serve(demo_jobs(args.jobs, m=args.m, n=args.n))
    for r in results:
        _LOG.info("job %d: T=%d final nnz=%d obj=%.5f latency=%.2fs",
                  r.extras["jid"], len(r.lambdas), int(r.active[-1]),
                  float(r.objectives[-1]), r.extras["latency_s"])
    write_artifacts(server)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
