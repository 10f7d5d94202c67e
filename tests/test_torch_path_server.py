"""The port's path server (``repro_torch.launch.path_server``) on the CPU:
continuous batching over the batched scan step, against the port's own
sequential scan paths and against the reference's ``PathServer``.

Workloads are ``demo_jobs`` (the same numpy arrays and grids in both
packages) at the reference test's sizes: 300 x 120, 100 x 60, 40 x 24.
Tolerances:

* each served job against the port's ``svm_path(engine="scan",
  reduce="compact")`` on its true X and grid: objectives rel 1e-6, weights
  atol 5e-3 (the slot's padded solve and the unpadded one sum in other
  orders, and the server estimates L on the padded slot);
* against the reference's server on the same jobs at the default stop
  rule: objectives rel 1e-5 (the reference's own host-vs-scan spread is
  7.9e-6), with both packages given the port's L (the reference's 30 power
  iterations stop lower than the port's 100);
* results trimmed to the true shape exactly, the program cache warm and
  never re-captured.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core.path import svm_path
from repro_torch.core.path_scan import compact_caps
from repro_torch.core.solver import lipschitz_estimate
from repro_torch.launch.path_server import PathJob, PathServer, demo_jobs

SOLVE = dict(tol=1e-10, max_iters=8000)


def _quiet(*a, **k):
    return None


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its tensors are small, and the
    suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    """One ragged 6-job workload through a 3-slot compact-mode server."""
    jobs = demo_jobs(6, m=300, n=120, seed=3)  # ragged T in [4, 10)
    server = PathServer(slots=3, reduce="compact", device="cpu", **SOLVE)
    results = server.serve(jobs, log=_quiet)
    return jobs, server, results


def _sequential(job, **kw):
    return svm_path(job.X, job.y, lambdas=job.lambdas, engine="scan", reduce="compact",
                    rules=job.rules, device="cpu", **kw)


def test_server_matches_sequential_paths(served):
    """Every served job reproduces its sequential scan path on its true X
    and grid: the padded slot solves the true problem through its sample
    mask."""
    jobs, _, results = served
    for job, r in zip(jobs, results):
        seq = _sequential(job, **SOLVE)
        assert _rel(r.objectives, seq.objectives) < 1e-6, job.jid
        np.testing.assert_allclose(r.weights, seq.weights, atol=5e-3)
        assert r.extras["jid"] == job.jid
        assert r.extras["engine"] == "serve"
        assert r.lambdas.shape == (job.n_lambdas,)


def test_server_results_trimmed_to_true_shape(served):
    """Bucket padding never leaks: results carry the job's true (T, m)
    shapes, screened features are exact zeros, and the reported caps and
    kept counts never exceed the true m."""
    jobs, _, results = served
    for job, r in zip(jobs, results):
        T, m = len(job.lambdas), job.X.shape[0]
        assert r.weights.shape == (T, m)
        assert r.extras["keep_masks"].shape == (T, m)
        assert np.all(r.weights[~r.extras["keep_masks"]] == 0.0)
        assert np.all(r.extras["caps"] <= m)
        assert np.all(r.kept <= m)


def test_server_cache_warm_and_no_retrace(served):
    """The program cache is reused (more hits than misses on a multi-job
    workload), one entry per miss, and no graph key is captured twice."""
    _, server, _ = served
    st = server.cache_stats()
    assert st["programs"] == st["misses"]
    assert st["hits"] > st["misses"], st
    assert st["retraces"] == 0, st


def test_server_occupancy_and_latency(served):
    """Continuous batching keeps slots busy across ragged grid lengths."""
    _, server, _ = served
    s = server.last_serve
    assert s["jobs"] == 6
    assert s["slot_occupancy"] > 0.5
    assert s["latency_p95_s"] >= s["latency_p50_s"] > 0.0
    assert s["jobs_per_s"] > 0.0


def test_server_matches_reference_server(monkeypatch):
    """The port's server against the reference's on the same two groups of
    jobs (``feature_vi`` and ``edpp``, 100 x 60), default stop rule, both
    given the port's L on the padded slot: the same grids, objectives rel
    1e-5, the same trimmed shapes."""
    import jax.numpy as jnp

    import repro.launch.path_server as ref_server

    monkeypatch.setattr(ref_server, "lipschitz_estimate", lambda Xp: jnp.asarray(
        float(lipschitz_estimate(torch.from_numpy(np.array(Xp)))), jnp.float32))

    def jobs(make):
        js = make(4, m=100, n=60, seed=7)
        for j in js[2:]:
            j.rules = "edpp"
        return js

    port = PathServer(slots=2, device="cpu").serve(jobs(demo_jobs), log=_quiet)
    ref = ref_server.PathServer(slots=2).serve(jobs(ref_server.demo_jobs), log=_quiet)
    for p, r in zip(port, ref):
        assert p.extras["jid"] == r.extras["jid"]
        np.testing.assert_allclose(p.lambdas, np.asarray(r.lambdas), rtol=1e-6)
        assert _rel(p.objectives, np.asarray(r.objectives)) < 1e-5, p.extras["jid"]
        assert p.weights.shape == np.asarray(r.weights).shape
        assert p.rules == tuple(r.rules)


def test_server_second_workload_bounded_compiles():
    """A second same-bucket workload on a warm server adds at most the
    remaining rungs of the capacity ladder: the key space of one group is
    (|caps| + 1) programs, never one per job or grid length."""
    server = PathServer(slots=2, reduce="compact", tol=1e-9, max_iters=4000,
                        device="cpu")
    server.serve(demo_jobs(3, m=100, n=60, seed=1), log=_quiet)
    server.serve(demo_jobs(3, m=100, n=60, seed=9), log=_quiet)
    st = server.cache_stats()
    assert st["programs"] <= len(compact_caps(128)) + 1  # m_b = bucket(100)
    assert st["retraces"] == 0


def test_server_mixed_buckets_and_rules():
    """Jobs from different shape buckets and rule configurations (VI, none,
    EDPP and auto, which resolves to EDPP: the weighted EDPP mode under the
    slots' sample masks) drain group by group through one server, each
    against its own sequential path."""
    a = demo_jobs(2, m=100, n=60, seed=21)
    b = demo_jobs(2, m=40, n=24, seed=22)
    c = demo_jobs(2, m=100, n=60, seed=23)
    for j in b:
        j.jid += 10
    for j, rules in zip(c, ("edpp", "auto")):
        j.jid += 20
        j.rules = rules
    b[1].rules = "none"  # a group of its own: screening is in the group key
    assert c[0].group_key() == c[1].group_key() != a[0].group_key()
    server = PathServer(slots=2, reduce="compact", tol=1e-9, max_iters=4000,
                        device="cpu")
    results = server.serve(a + b + c, log=_quiet)
    assert [r.extras["jid"] for r in results] == [0, 1, 10, 11, 20, 21]
    for job, r in zip(a + b + c, results):
        seq = _sequential(job, tol=1e-9, max_iters=4000)
        assert _rel(r.objectives, seq.objectives) < 1e-6, job.jid
        assert r.screened == job.screening
        assert r.rules == seq.rules


def test_server_rejects_unknown_rules():
    job = PathJob(jid=0, X=np.eye(8, dtype=np.float32), y=np.ones(8, np.float32),
                  rules="sample_vi")
    with pytest.raises(ValueError, match="feature rules only"):
        job.group_key()
    job.rules = "dvi"
    with pytest.raises(ValueError, match="single anchor"):
        job.group_key()
    with pytest.raises(ValueError, match="mask' or 'compact"):
        PathServer(reduce="gather", device="cpu")


def test_server_main_writes_artifacts(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.path_server`` and the launcher's
    ``--serve`` write the serve summary and the metrics under the working
    directory; ``--engine`` does not apply to ``--serve``."""
    from repro_torch.launch import path_server
    from repro_torch.launch.train_svm import main as train_main

    monkeypatch.chdir(tmp_path)
    assert path_server.main(["--jobs", "3", "--slots", "2", "--m", "40", "--n", "24",
                             "--device", "cpu"]) == 0
    assert (tmp_path / "artifacts" / "svm_serve.json").exists()
    assert train_main(["--serve", "--serve-jobs", "2", "--serve-slots", "2", "--m", "40",
                       "--n", "24", "--reduce", "mask", "--device", "cpu"]) == 0
    summary = json.loads((tmp_path / "artifacts" / "svm_serve.json").read_text())
    assert summary["jobs"] == 2 and summary["retraces"] == 0
    assert "serve.steps" in json.loads(
        (tmp_path / "artifacts" / "svm_serve_metrics.json").read_text())
    with pytest.raises(SystemExit, match="do not apply"):
        train_main(["--serve", "--engine", "scan", "--device", "cpu"])


def test_slot_residue_and_padding_are_zero():
    """A smaller job entering a slot that a larger one left sees zeros past
    its true shape, and a padded row's weight is exactly 0 in every step
    the slot ran."""
    big = demo_jobs(1, m=120, n=60, seed=31)[0]
    small = demo_jobs(1, m=70, n=40, seed=32)[0]
    small.jid = 1
    assert big.group_key() == small.group_key()
    server = PathServer(slots=1, device="cpu")
    server.serve([big], log=_quiet)
    server._insert(0, small)
    Xs = server._X[0]
    assert torch.equal(Xs[:70, :40], torch.from_numpy(small.X))
    assert not bool(Xs[70:].any()) and not bool(Xs[:, 40:].any())
    assert not bool(server._y[0, 40:].any()) and float(server._sm[0].sum()) == 40.0
    server._act[0] = False
    server._slot_jobs[0] = None
    (r,) = server.serve([demo_jobs(1, m=70, n=40, seed=32)[0]], log=_quiet)
    for st in server._tracked_done[0].steps:
        assert np.all(st["w"][70:] == 0.0) and not st["fmask"][70:].any()
    assert r.weights.shape[1] == 70
