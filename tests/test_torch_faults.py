"""Fault injection (``repro_torch/testing/faults.py``): the port's recovery
chains against the reference's on the same inputs.

Inputs: ``make_sparse_classification(m=80, n=48, k_active=6, seed=3)`` made
with numpy (the reference's ``tests/test_faults.py`` instance). The
invariants, as the reference states them:

1. a poisoned solve at a path step (``poison_path_step(2)``) makes the next
   step's certificate refused (``HEALTH_SCREEN_REFUSED``), that step keeps
   every feature (a superset of the clean run's keeps up to it), its warm
   start is sanitized, and the path recovers: the other steps' objectives
   within 1e-4 of the clean run. The step after the keep-all one screens
   from an anchor solved on every feature, whose certificate can be tighter
   than the clean run's (55 kept against 59 in mask mode here), so it is
   held to safety: no feature that the unscreened path uses is screened.
   Held against the reference's ``PathDriver`` with its own injector at
   fixed iterations: the same health words, the same kept counts at the
   closed-form anchor's step and the refused step (the others are not
   comparable step by step, ROADMAP queue 3), objectives within rel 1e-5;
2. a corrupt store chunk is detected by its checksum before its bytes join
   any sweep;
3. transient read faults are absorbed by the retry; persistent ones raise a
   typed ``StoreError``; the launcher turns a store failure into one log
   line and exit code 2.
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.path import PathDriver as RefDriver
from repro.sparse.chunked import FeatureChunked as RefChunked
from repro.testing import faults as ref_faults
from repro_torch.core.path import PathDriver
from repro_torch.core.screening import anchor_stats, fixed_stats
from repro_torch.core.solver import HEALTH_SCREEN_REFUSED
from repro_torch.data import make_sparse_classification
from repro_torch.launch.train_svm import main as train_main
from repro_torch.sparse.chunked import (
    FeatureChunked,
    StoreCorruptError,
    StoreError,
    StoreMissingError,
)
from repro_torch.sparse.screen_stream import (
    ChunkScreenCache,
    fixed_reductions,
    screen_step_stream,
)
from repro_torch.sparse.solver_stream import fista_solve_chunked
from repro_torch.testing import faults

ROOT = Path(__file__).resolve().parents[1]
FIXED = dict(tol=-1.0, max_iters=300)


@pytest.fixture(scope="module")
def ds():
    return make_sparse_classification(m=80, n=48, k_active=6, seed=3)


def _driver(**kw):
    return PathDriver("feature_vi", tol=1e-8, max_iters=1500, device="cpu", **kw)


def _run(driver, X, y, T=5):
    return driver.run(X, y, n_lambdas=T, lam_min_ratio=0.2)


@pytest.fixture(scope="module")
def support(ds):
    """The features the unscreened path uses, per step."""
    full = _run(PathDriver([], tol=1e-12, max_iters=20000, device="cpu"), ds.X, ds.y)
    return np.abs(full.weights) > 1e-6


# -- invariant 1: poisoned solve -> keep-all fail-safe, then full recovery ----


@pytest.mark.parametrize("reduce", ["gather", "mask"])
def test_poisoned_path_step_keeps_superset_and_recovers(ds, support, reduce):
    clean = _run(_driver(reduce=reduce), ds.X, ds.y)
    drv = _driver(reduce=reduce)
    drv._fault_injector = faults.poison_path_step(2)
    poisoned = _run(drv, ds.X, ds.y)
    assert drv._fault_injector.state["fired"]

    health = poisoned.extras["health"]
    assert health[3] & HEALTH_SCREEN_REFUSED  # the refused certificate
    assert not np.any(clean.extras["health"])
    assert np.all(poisoned.kept[:4] >= clean.kept[:4])
    assert poisoned.kept[3] == ds.X.shape[0]  # keep-all
    assert not np.any(support & ~poisoned.extras["keep_masks"])
    assert health[3] & (HEALTH_SCREEN_REFUSED - 1)  # the warm start was sanitized
    for k in range(len(clean.lambdas)):
        if k != 2:
            assert abs(poisoned.objectives[k] - clean.objectives[k]) < 1e-4
    assert np.allclose(poisoned.weights[-1], clean.weights[-1], atol=1e-4)
    assert np.isnan(poisoned.weights[2, 0]) and np.isnan(poisoned.biases[2])
    assert not np.isfinite(poisoned.extras["path_trace"].steps[2].delta)


@pytest.mark.parametrize("storage", ["dense", "chunked"])
def test_poisoned_path_step_matches_reference(ds, storage):
    """The same poison through both packages at fixed iterations: the same
    refused steps and kept counts, objectives within rel 1e-5."""
    port = PathDriver("feature_vi", device="cpu", **FIXED)
    port._fault_injector = faults.poison_path_step(2)
    ref = RefDriver("feature_vi", **FIXED)
    ref._fault_injector = ref_faults.poison_path_step(2)
    if storage == "dense":
        got = _run(port, ds.X, ds.y)
        want = _run(ref, jnp.asarray(ds.X), jnp.asarray(ds.y))
    else:
        got = _run(port, FeatureChunked.from_dense(ds.X, chunk_m=16), ds.y)
        want = _run(ref, RefChunked.from_dense(np.asarray(ds.X), chunk_m=16), ds.y)
    np.testing.assert_array_equal(got.extras["health"], np.asarray(want.extras["health"]))
    assert got.extras["health"][3] & HEALTH_SCREEN_REFUSED
    for k in (1, 3):
        assert got.kept[k] == int(want.kept[k])
    keep = np.arange(len(got.lambdas)) != 2
    rel = (np.abs(got.objectives - np.asarray(want.objectives))
           / np.abs(np.asarray(want.objectives)))
    assert rel[keep].max() <= 1e-5


def test_poisoned_chunked_path_recovers(ds, support):
    clean = _run(_driver(), FeatureChunked.from_dense(ds.X, chunk_m=16), ds.y)
    drv = _driver()
    drv._fault_injector = faults.poison_path_step(2)
    poisoned = _run(drv, FeatureChunked.from_dense(ds.X, chunk_m=16), ds.y)
    assert poisoned.extras["health"][3] & HEALTH_SCREEN_REFUSED
    assert np.all(poisoned.kept[:4] >= clean.kept[:4])
    assert poisoned.kept[3] == ds.X.shape[0]
    assert not np.any(support & ~poisoned.extras["keep_masks"])
    for k in range(len(clean.lambdas)):
        if k != 2:
            assert abs(poisoned.objectives[k] - clean.objectives[k]) < 1e-4


def test_stream_solver_guard_rolls_back(ds):
    fc = FeatureChunked.from_dense(ds.X, chunk_m=16)
    y = torch.from_numpy(ds.y)
    clean = fista_solve_chunked(fc, y, 1.0, max_iters=400)
    assert int(clean.health) == 0
    hook = faults.poison_stream_iterate(2)
    hooked = fista_solve_chunked(fc, y, 1.0, max_iters=400, iteration_hook=hook)
    assert hook.state["fired"]
    assert int(hooked.health) >= 1
    assert abs(float(hooked.obj) - float(clean.obj)) < 1e-4


def test_poisoned_warm_start_sanitized(ds):
    fc = FeatureChunked.from_dense(ds.X, chunk_m=16)
    y = torch.from_numpy(ds.y)
    clean = fista_solve_chunked(fc, y, 1.0, max_iters=400)
    w0 = torch.zeros((fc.shape[0],))
    w0[1] = float("nan")
    res = fista_solve_chunked(fc, y, 1.0, w0=w0, b0=float("nan"), max_iters=400)
    assert int(res.health) >= 2
    assert abs(float(res.obj) - float(clean.obj)) < 1e-4


# -- invariant 2: corruption detected before the bytes are used ---------------


def test_corrupt_chunk_detected_before_screening(tmp_path, ds):
    sd = str(tmp_path / "store")
    FeatureChunked.from_dense(ds.X, chunk_m=16).save_store(sd, y=ds.y)
    # flip bytes in grid chunk 1 (rows 16..32 of the dense payload)
    faults.corrupt_store_bytes(os.path.join(sd, "X.bin"), offset=17 * ds.X.shape[1] * 4)
    fc = FeatureChunked.from_store(sd)
    y = torch.from_numpy(ds.y)
    lam_max = float(np.max(np.abs(ds.X @ (ds.y - np.mean(ds.y)))))
    with pytest.raises(StoreCorruptError, match="chunk 1"):
        screen_step_stream(fc, y, lam_max, 0.5 * lam_max, torch.zeros(ds.X.shape[1]))


def test_truncated_and_missing_store_typed_errors(tmp_path, ds):
    sd = str(tmp_path / "store")
    FeatureChunked.from_dense(ds.X, chunk_m=16).save_store(sd)
    faults.truncate_store_file(os.path.join(sd, "X.bin"), nbytes=64)
    with pytest.raises(StoreCorruptError, match="truncated"):
        FeatureChunked.from_store(sd)
    with pytest.raises(StoreMissingError):
        FeatureChunked.from_store(str(tmp_path / "absent"))


def test_flaky_reads_absorbed_dead_reads_raise(tmp_path, ds):
    sd = str(tmp_path / "store")
    FeatureChunked.from_dense(ds.X, chunk_m=16).save_store(sd, y=ds.y)
    with faults.flaky_reads(n_failures=1) as counts:
        fc = FeatureChunked.from_store(sd)
        fc.verify()
        assert counts  # at least one injected failure was retried through
    with faults.dead_reads():
        with pytest.raises(StoreError):
            FeatureChunked.from_store(sd)


def test_libsvm_rebuild_fallback(tmp_path):
    p = str(tmp_path / "toy.svm")
    with open(p, "w") as f:
        f.write("+1 1:0.5 3:1.5\n-1 2:2.0\n+1 1:1.0 4:0.25\n")
    fc, y = FeatureChunked.from_libsvm_cached(p, chunk_m=2)
    ref = fc.as_dense().copy()
    faults.corrupt_store_bytes(os.path.join(p + ".store", "data.bin"))
    fc2, y2 = FeatureChunked.from_libsvm_cached(p, chunk_m=2)
    fc2.verify()
    assert np.array_equal(fc2.as_dense(), ref)
    assert np.array_equal(y2, y)


def test_chunk_cache_refresh_rejects_poisoned_anchor(ds):
    fc = FeatureChunked.from_dense(ds.X, chunk_m=16)
    y = torch.from_numpy(ds.y)
    fixed = fixed_stats(y, *fixed_reductions(fc, y))
    theta = torch.zeros((ds.X.shape[1],))
    d_theta = torch.zeros((fc.shape[0],))
    cache = ChunkScreenCache(fc)
    cache.refresh(anchor_stats(y, 2.0, theta, 0.0, d_theta))
    live, _ = cache.live_mask(1.0, fixed)
    assert not live.all()  # a zero anchor certifies plenty dead
    bad = theta.clone()
    bad[0] = float("nan")
    cache.refresh(anchor_stats(y, 2.0, bad, float("nan"), d_theta))
    live2, bounds2 = cache.live_mask(1.0, fixed)
    assert live2.all()  # the poisoned anchor invalidated the cache
    assert np.all(np.isinf(bounds2.numpy()))


# -- the launcher: a store failure exits 2 -------------------------------------


def _store(tmp_path, ds) -> str:
    sd = str(tmp_path / "store")
    FeatureChunked.from_dense(ds.X, chunk_m=16).save_store(sd, y=ds.y)
    return sd


@pytest.mark.parametrize("fault", ["corrupt", "truncate", "missing"])
def test_launcher_store_failure_exits_2(tmp_path, monkeypatch, ds, fault):
    """``--storage mmap --store-dir DIR`` on a damaged or absent store: one
    error line naming the typed error, exit code 2 (the reference's
    ``main``), before any screen."""
    monkeypatch.chdir(tmp_path)
    sd = _store(tmp_path, ds)
    if fault == "corrupt":
        faults.corrupt_store_bytes(os.path.join(sd, "X.bin"), offset=4 * ds.X.shape[1])
    elif fault == "truncate":
        faults.truncate_store_file(os.path.join(sd, "X.bin"), nbytes=64)
    else:
        sd = str(tmp_path / "absent")
    records = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = records.append
    logger = logging.getLogger("repro_torch")
    logger.addHandler(handler)
    try:
        with pytest.raises(SystemExit) as e:
            train_main(["--storage", "mmap", "--store-dir", sd, "--chunk-m", "16",
                        "--device", "cpu"])
    finally:
        logger.removeHandler(handler)
    assert e.value.code == 2
    errors = [r for r in records if r.levelno >= logging.ERROR]
    assert len(errors) == 1
    want = {"corrupt": "StoreCorruptError", "truncate": "StoreCorruptError",
            "missing": "StoreMissingError"}[fault]
    assert errors[0].getMessage().startswith(want + ": ")
    assert not (tmp_path / "artifacts").exists()


def test_launcher_store_failure_has_no_traceback(tmp_path, ds):
    """The same run as a process: exit code 2, one error line, no
    traceback."""
    sd = _store(tmp_path, ds)
    faults.corrupt_store_bytes(os.path.join(sd, "X.bin"), offset=4 * ds.X.shape[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_svm", "--storage", "mmap",
         "--store-dir", sd, "--chunk-m", "16", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr
    assert "Traceback" not in out.stderr + out.stdout
    assert "StoreCorruptError: checksum mismatch" in out.stderr
    ok = _store(tmp_path / "good", ds)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_svm", "--storage", "mmap",
         "--store-dir", ok, "--chunk-m", "16", "--n-lambdas", "3", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "live_chunks=" in out.stdout


# -- the path server: kill and resume, quarantine, retry, deadline ------------------


def _serve_jobs():
    from repro_torch.launch.path_server import demo_jobs

    return demo_jobs(4, m=96, n=48)


def _server(**kw):
    from repro_torch.launch.path_server import PathServer

    return PathServer(slots=2, device="cpu", **kw)


def test_server_kill_resume_equals_uninterrupted(tmp_path):
    """A server killed after 4 steps (``kill_server_after``) and served again
    from its snapshots gives the uninterrupted run's results bit for bit."""
    ref = _server().serve(_serve_jobs(), log=lambda *a: None)
    sd = str(tmp_path / "snap")
    crashed = _server()
    crashed._step_hook = faults.kill_server_after(4)
    with pytest.raises(faults.ServerKilled):
        crashed.serve(_serve_jobs(), log=lambda *a: None, snapshot_dir=sd,
                      snapshot_every=1)
    resumed = _server().serve(_serve_jobs(), log=lambda *a: None, snapshot_dir=sd,
                              snapshot_every=1)
    assert all(r is not None for r in resumed)
    for ra, rb in zip(ref, resumed):
        assert np.array_equal(ra.objectives, rb.objectives)
        assert np.array_equal(ra.weights, rb.weights)
        assert np.array_equal(ra.extras["health"], rb.extras["health"])


def test_server_quarantine_isolates_tenant():
    """A tenant whose slot 0 step is poisoned with no retries left is evicted
    with ``status="failed"``; the other three finish within 1e-4 of the
    clean run (the failed slot's zeroed carry reaches no other slot; the
    shared compact capacity may differ once it is gone)."""
    clean = _server().serve(_serve_jobs(), log=lambda *a: None)
    jobs = _serve_jobs()
    for j in jobs:
        j.max_retries = 0
    srv = _server()
    srv._fault_injector = faults.poison_server_slot(slot=0, at_step=2)
    res = srv.serve(jobs, log=lambda *a: None)
    failed = [j for j in jobs if j.status == "failed"]
    assert len(failed) == 1 and "non-finite" in failed[0].error
    assert srv.stats["jobs_failed"] == 1
    assert sum(r is None for r in res) == 1 and sum(r is not None for r in res) == 3
    for r, c in zip(res, clean):
        if r is not None:
            assert np.max(np.abs(r.objectives - c.objectives)) < 1e-4


def test_server_retry_recovers_transient_poison():
    """A poison that hits one step once is rolled back and retried: every
    job finishes, within 1e-4 of the clean run."""
    ref = _server().serve(_serve_jobs(), log=lambda *a: None)
    srv = _server()
    srv._fault_injector = faults.poison_server_slot(slot=0, at_step=3)
    res = srv.serve(_serve_jobs(), log=lambda *a: None)
    assert srv._fault_injector.state["fired"] == 1
    assert srv.stats["retries"] >= 1 and srv.stats["jobs_failed"] == 0
    assert all(r is not None for r in res)
    for ra, rb in zip(ref, res):
        assert np.max(np.abs(ra.objectives - rb.objectives)) < 1e-4


def test_server_poisoned_carry_heals_in_the_solver():
    """The reference's poison (a NaN bias in a slot's carry, its guard
    switched off) needs no retry here: the port's guard is always on, the
    next solve sanitizes the warm start (one trip in its health word) and
    the step's outputs are finite, which is why the server tests poison the
    outputs through ``_fault_injector`` instead."""
    srv = _server()
    state = {"hit": False}

    def poison_bias(step):
        if step == 2 and not state["hit"] and srv._act[0]:
            state["hit"] = True
            b = srv._carry[1].clone()
            b[0] = float("nan")
            srv._carry = (srv._carry[0], b) + srv._carry[2:]

    srv._step_hook = poison_bias
    res = srv.serve(_serve_jobs(), log=lambda *a: None)
    assert state["hit"] and srv.stats["retries"] == 0
    assert all(r is not None for r in res)
    assert any(int(r.extras["health"][2]) & 0xFFFF for r in res)


def test_server_deadline_evicts():
    import time

    jobs = _serve_jobs()[:2]
    jobs[0].deadline_s = 0.0
    jobs[0].t_start = time.perf_counter() - 1.0
    res = _server().serve(jobs, log=lambda *a: None)
    assert jobs[0].status == "failed" and "deadline" in jobs[0].error
    assert res[0] is None and res[1] is not None
