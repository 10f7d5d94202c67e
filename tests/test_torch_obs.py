"""The port's observability layer (``repro_torch/obs``): the span recorder,
the metrics registry mirroring ``FeatureChunked.stats`` bit for bit, the
uniform ``PathTrace`` on every engine, and the spans and metrics the
engines emit, against the reference's names on the same paths.

Inputs: ``make_sparse_classification(m=120, n=60, k_active=8, seed=0)``
made with numpy (the reference's ``tests/test_obs.py`` instance). Paths in
the comparisons with the reference run at fixed iterations (``tol = -1``,
60 iterations a step) with the same L: span names and ``PathStep`` fields
equal, per-step ``lam``, ``iters`` and ``health`` equal, step 1's kept count
equal (later ones are not comparable step by step, ROADMAP queue 3). The
port's scan engines add a ``scan.solve`` span a step (from their host-loop
solve seconds) to the reference's ``scan.step``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.path import PathDriver as RefDriver
from repro.core.path_scan import svm_path_scan as ref_scan
from repro.obs import trace as ref_trace
from repro.obs.path_trace import PathStep as RefStep
from repro.sparse import FeatureChunked as RefChunked
from repro_torch.core import distributed as D
from repro_torch.core.path import PathDriver, svm_path
from repro_torch.core.path_scan import svm_path_scan, svm_path_scan_sharded
from repro_torch.core.solver import lipschitz_estimate
from repro_torch.data import make_sparse_classification
from repro_torch.launch.train_svm import main as train_main
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.path_trace import PathStep, PathTrace, build_path_trace
from repro_torch.obs.trace import NOOP_SPAN, Tracer
from repro_torch.sparse import FeatureChunked

SOLVE = dict(tol=1e-9, max_iters=4000)
FIXED = dict(tol=-1.0, max_iters=60)
PATH_SPANS = ("path.screen", "path.solve", "path.certify", "path.step")


@pytest.fixture()
def tracer():
    """A private enabled tracer (does not touch the process singleton)."""
    return Tracer(enabled=True)


@pytest.fixture(autouse=True)
def _quiet_registry():
    """Reset the process registry around every test so counter equality
    checks see only this test's increments."""
    obs_metrics.reset()
    yield
    obs_metrics.reset()


@pytest.fixture()
def traced():
    """Both packages' process tracers on and empty; off again after."""
    for t in (obs_trace, ref_trace):
        t.get_tracer().clear()
        t.enable()
    yield
    for t in (obs_trace, ref_trace):
        t.disable()
        t.get_tracer().clear()


@pytest.fixture(scope="module")
def ds():
    return make_sparse_classification(m=120, n=60, k_active=8, seed=0)


@pytest.fixture(scope="module")
def L(ds):
    return float(lipschitz_estimate(torch.from_numpy(ds.X)))


def _names(tracer_mod, prefix=""):
    return sorted(e["name"] for e in tracer_mod.get_tracer().events
                  if e["name"].startswith(prefix))


# -- span recorder ----------------------------------------------------------


def test_span_nesting_and_export_roundtrip(tracer, tmp_path):
    with tracer.span("outer", step=1):
        with tracer.span("inner", phase="solve"):
            pass
        tracer.instant("marker", note="hi")
    evs = tracer.events
    assert [e["name"] for e in evs] == ["inner", "marker", "outer"]
    inner, outer = evs[0], evs[2]
    assert outer["ph"] == "X" and inner["ph"] == "X"
    assert outer["args"] == {"step": 1} and inner["args"] == {"phase": "solve"}
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    out = tmp_path / "trace.json"
    tracer.export_chrome(out)
    doc = json.loads(out.read_text())
    byname = {e["name"]: e for e in doc["traceEvents"]}
    assert byname["process_name"]["ph"] == "M"
    assert byname["process_name"]["args"] == {"name": "repro_torch"}
    assert byname["outer"]["args"] == {"step": 1}
    assert byname["marker"]["ph"] == "i"
    assert all("pid" in e for e in doc["traceEvents"])


def test_span_set_attaches_attrs_mid_span(tracer):
    with tracer.span("solve") as sp:
        sp.set(iters=17)
    (ev,) = tracer.events
    assert ev["args"] == {"iters": 17}


def test_disabled_mode_is_noop_singleton():
    t = Tracer(enabled=False)
    assert t.span("solve", step=1) is NOOP_SPAN
    assert t.span("other") is NOOP_SPAN
    with t.span("solve"):
        t.instant("marker")
    t.add_complete_event("post", 0.0, 1.0)
    assert t.events == []
    was = obs_trace.enabled()
    obs_trace.disable()
    try:
        assert obs_trace.span("x") is NOOP_SPAN
        n0 = len(obs_trace.get_tracer().events)
        obs_trace.complete("x", 0.0, 1.0)
        obs_trace.instant("x")
        assert len(obs_trace.get_tracer().events) == n0
    finally:
        if was:
            obs_trace.enable()


def test_thread_safety_under_concurrent_spans(tracer):
    import threading

    barrier = threading.Barrier(4)

    def work(i):
        barrier.wait()
        for k in range(50):
            with tracer.span("w", tid_hint=i, k=k):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    evs = tracer.events
    assert len(evs) == 200 and len({e["tid"] for e in evs}) == 4


# -- metrics registry -------------------------------------------------------


def test_metric_kinds_and_dumps():
    c = obs_metrics.counter("t.count")
    c.inc()
    c.inc(4)
    obs_metrics.gauge("t.gauge").set_max(7)
    obs_metrics.gauge("t.gauge").set_max(3)
    h = obs_metrics.histogram("t.hist")
    for v in (1.0, 3.0):
        h.observe(v)
    snap = obs_metrics.snapshot()
    assert snap["t.count"] == 5 and snap["t.gauge"] == 7
    assert snap["t.hist"] == {"count": 2, "sum": 4.0, "min": 1.0, "max": 3.0, "mean": 2.0}
    with pytest.raises(TypeError):
        obs_metrics.gauge("t.count")
    assert json.loads(obs_metrics.to_json())["t.count"] == 5
    prom = obs_metrics.to_prometheus()
    assert "repro_t_count_total 5" in prom and "repro_t_hist_count 2" in prom


@pytest.mark.parametrize("dynamic", [False, True])
def test_registry_mirrors_stream_stats_bitwise(ds, dynamic):
    """The ``stream.*`` counters equal ``FeatureChunked.stats`` exactly after
    a chunked path (the gauge its ``max_put_rows``)."""
    fc = FeatureChunked.from_dense(ds.X, chunk_m=32)
    PathDriver(dynamic=dynamic, screen_every=25, device="cpu", **SOLVE).run(
        fc, ds.y, n_lambdas=4)
    snap = obs_metrics.snapshot()
    for key in ("puts", "chunks_streamed", "chunks_skipped", "bytes_put", "csr_puts",
                "stage_s"):
        assert snap.get(f"stream.{key}", 0) == fc.stats[key], key
    assert snap["stream.max_put_rows"] == fc.stats["max_put_rows"]
    assert snap["path.steps"] == 4


def test_path_metrics_follow_every_engine(ds):
    """``path.steps``, ``path.guard_trips`` and the ``path.kept`` histogram
    (``PathDriver._observe_run``) from the host, scan and batched engines."""
    T = 4
    host = svm_path(ds.X, ds.y, n_lambdas=T, device="cpu", **SOLVE)
    svm_path(ds.X, ds.y, n_lambdas=T, engine="scan", device="cpu", **SOLVE)
    svm_path(np.stack([ds.X, ds.X]), np.stack([ds.y, ds.y]), n_lambdas=T,
             engine="batched", device="cpu", **SOLVE)
    snap = obs_metrics.snapshot()
    assert snap["path.steps"] == 4 * T
    assert snap["path.guard_trips"] == 0
    assert snap["path.kept"]["count"] == 4 * T
    assert host.kept.max() <= snap["path.kept"]["max"] <= ds.X.shape[0]


# -- PathTrace ----------------------------------------------------------------


def _assert_schema(pt, T):
    assert isinstance(pt, PathTrace) and len(pt.steps) == T
    for k, s in enumerate(pt.steps):
        assert isinstance(s, PathStep) and s.step == k
        assert s.kept >= 0 and s.iters >= 0
    assert pt.total_s >= 0.0
    json.dumps(pt.to_dict())


def test_path_trace_uniform_across_engines(ds):
    """host, scan, batched, the sharded scan (a 1 x 1 grid) and chunked
    runs all attach the same PathTrace schema, one record per lambda."""
    T = 4
    host = svm_path(ds.X, ds.y, n_lambdas=T, device="cpu", **SOLVE)
    traces = {
        "host": host.extras["path_trace"],
        "scan": svm_path(ds.X, ds.y, n_lambdas=T, engine="scan", device="cpu",
                         **SOLVE).extras["path_trace"],
        "batched": svm_path(ds.X, ds.y, lambdas=host.lambdas[None, :], engine="batched",
                            device="cpu", **SOLVE)[0].extras["path_trace"],
        "scan_sharded": svm_path_scan_sharded(D.svm_grid(1, 1), ds.X, ds.y,
                                              lambdas=host.lambdas, device="cpu",
                                              **SOLVE).extras["path_trace"],
        "chunked": PathDriver(device="cpu", **SOLVE).run(
            FeatureChunked.from_dense(ds.X, chunk_m=32), ds.y,
            lambdas=host.lambdas).extras["path_trace"],
    }
    for name, pt in traces.items():
        assert pt.engine == name
        _assert_schema(pt, T)
        np.testing.assert_allclose([s.lam for s in pt.steps], host.lambdas)
    for name in ("host", "chunked"):
        assert traces[name].walls_observed
        for s in traces[name].steps:
            assert np.isfinite(s.screen_s) and np.isfinite(s.certify_s)
            assert s.screen_s + s.solve_s + s.certify_s <= s.wall_s + 1e-6
    for name in ("scan", "batched", "scan_sharded"):
        pt = traces[name]
        assert not pt.walls_observed
        assert all(np.isfinite(s.solve_s) and np.isfinite(s.gap) for s in pt.steps)
    assert traces["chunked"].meta["storage"] == "chunked"


def test_path_trace_emits_synthesized_spans():
    pt = build_path_trace("scan", [1.0, 0.5], [3, 5], None, [1, 2], [10, 20],
                          [0.5, 0.5], total_s=1.0, walls_observed=False)
    t = Tracer(enabled=True)
    pt.emit_to_tracer(t)
    evs = [e for e in t.events if e["name"] == "scan.step"]
    assert len(evs) == 2
    assert evs[0]["ts"] + evs[0]["dur"] == pytest.approx(evs[1]["ts"])
    t2 = Tracer(enabled=False)
    pt.emit_to_tracer(t2)
    assert t2.events == []


# -- against the reference: the same names on the same paths -----------------------


@pytest.mark.parametrize("storage", ["dense", "chunked"])
def test_host_spans_and_trace_match_reference(ds, L, traced, storage):
    """The same path through both packages with tracing on: the same span
    names (four a step), the same ``PathStep`` fields, per-step ``lam``,
    ``iters`` and ``health`` equal and step 1's kept count equal; the
    port's spans add up to its ``screen_times``, solve and ``wall_times``."""
    T = 5
    if storage == "dense":
        got = PathDriver(L=L, device="cpu", **FIXED).run(ds.X, ds.y, n_lambdas=T)
        want = RefDriver(L=L, **FIXED).run(jnp.asarray(ds.X), jnp.asarray(ds.y),
                                           n_lambdas=T)
    else:
        got = PathDriver(L=L, device="cpu", **FIXED).run(
            FeatureChunked.from_dense(ds.X, chunk_m=32), ds.y, n_lambdas=T)
        want = RefDriver(L=L, **FIXED).run(RefChunked.from_dense(ds.X, chunk_m=32),
                                           ds.y, n_lambdas=T)
    assert _names(obs_trace, "path.") == _names(ref_trace, "path.")
    assert _names(obs_trace, "path.").count("path.step") == T - 1
    pt, rt = got.extras["path_trace"], want.extras["path_trace"]
    assert list(PathStep.__dataclass_fields__) == list(RefStep.__dataclass_fields__)
    assert pt.engine == rt.engine and pt.walls_observed == rt.walls_observed
    for a, b in zip(pt.steps, rt.steps):
        assert (a.step, a.iters, a.health) == (b.step, b.iters, b.health)
        assert a.lam == pytest.approx(b.lam, rel=1e-6)
    assert pt.steps[1].kept == rt.steps[1].kept
    ev = obs_trace.get_tracer().events
    dur = {n: np.array([e["dur"] for e in ev if e["name"] == n]) * 1e-6 for n in PATH_SPANS}
    solve = (got.extras["solve_times"] if storage == "dense" else
             got.extras["part_times"]["gather_s"] + got.extras["part_times"]["solve_s"])
    np.testing.assert_allclose(dur["path.screen"], got.screen_times[1:], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dur["path.solve"], solve[1:], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dur["path.step"], got.wall_times[1:], rtol=1e-6, atol=1e-9)


def test_scan_spans_match_reference(ds, traced):
    """The scan engine: the reference's ``scan.dispatch`` and ``scan.step``
    spans, and the port's ``scan.solve`` a step; the ``PathTrace``'s
    iterations and health equal at fixed iterations."""
    T = 4
    got = svm_path_scan(ds.X, ds.y, n_lambdas=T, device="cpu", **FIXED)
    want = ref_scan(jnp.asarray(ds.X), jnp.asarray(ds.y), n_lambdas=T, **FIXED)
    ref_names = set(_names(ref_trace, "scan."))
    port_names = _names(obs_trace, "scan.")
    assert ref_names == {"scan.dispatch", "scan.step"}
    assert set(port_names) == ref_names | {"scan.solve"}
    assert port_names.count("scan.step") == port_names.count("scan.solve") == T
    pt, rt = got.extras["path_trace"], want.extras["path_trace"]
    assert [s.iters for s in pt.steps] == [s.iters for s in rt.steps]
    assert [s.health for s in pt.steps] == [s.health for s in rt.steps]
    np.testing.assert_array_equal([s.solve_s for s in pt.steps], got.extras["solve_seconds"])


def test_tracing_adds_no_device_sync(ds, L):
    """The scan engine's host fetches (its only device syncs) are the same
    with tracing on and off."""
    kw = dict(n_lambdas=4, engine="scan", device="cpu", **FIXED)
    off = svm_path(ds.X, ds.y, **kw).extras["host_fetches"]
    obs_trace.get_tracer().clear()
    obs_trace.enable()
    try:
        on = svm_path(ds.X, ds.y, **kw).extras["host_fetches"]
        assert obs_trace.get_tracer().events  # it did record
    finally:
        obs_trace.disable()
        obs_trace.get_tracer().clear()
    assert on == off


def test_launcher_trace_and_profile(tmp_path, monkeypatch):
    """``--trace FILE``: Chrome JSON with the host path's spans;
    ``--profile DIR``: a ``torch.profiler`` trace holding the
    ``record_function`` regions named as the spans."""
    monkeypatch.chdir(tmp_path)
    try:
        assert train_main(["--m", "120", "--n", "60", "--n-lambdas", "4",
                           "--device", "cpu", "--trace", "t.json",
                           "--profile", "prof"]) == 0
    finally:
        obs_trace.disable()
        obs_trace.get_tracer().clear()
    doc = json.loads((tmp_path / "t.json").read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    for span in PATH_SPANS:
        assert names.count(span) == 3, span
    prof = (tmp_path / "prof" / "profile.json").read_text()
    for span in PATH_SPANS:
        assert f'"{span}"' in prof, span


# -- the path server ------------------------------------------------------------------


def test_registry_mirrors_server_stats_bitwise():
    """Every ``serve.*`` counter equals the server's ``stats`` after a drain,
    and ``metrics()`` returns the snapshot with the cache's state absorbed;
    the ``path.*`` counters fold in the assembled per-job traces."""
    from repro_torch.launch.path_server import PathServer, demo_jobs

    server = PathServer(slots=2, device="cpu", **SOLVE)
    jobs = demo_jobs(3, m=60, n=40, seed=1)
    results = server.serve(jobs, log=lambda *a, **k: None)
    assert all(r is not None for r in results)
    snap = server.metrics()
    for key, val in server.stats.items():
        # counters register lazily; never-incremented ones read 0
        assert snap.get(f"serve.{key}", 0) == val, key
    for key, val in server.cache_stats().items():
        assert snap[f"serve.cache.{key}"] == val, key
    assert snap["serve.latency_s"]["count"] == len(jobs)
    assert snap["serve.slot_occupancy"] == server.last_serve["slot_occupancy"]
    assert snap["path.steps"] == sum(len(j.lambdas) for j in jobs)


def test_serve_path_trace_and_spans_match_reference(ds, traced):
    """A served job attaches the PathTrace layout of the host and scan
    engines (one record per lambda, ``engine="serve"``, synthesized walls,
    its latency in ``total_s``, ``jid`` in ``meta``), and the server records
    the reference's span names on the same job: ``serve.refill``,
    ``serve.step`` and the synthesized per-step spans (the port adds a
    ``serve.solve`` span a step from its solve seconds, as its scan engine
    adds ``scan.solve``)."""
    from repro.launch.path_server import PathJob as RefJob
    from repro.launch.path_server import PathServer as RefServer
    from repro_torch.launch.path_server import PathJob, PathServer

    T = 4
    host = svm_path(ds.X, ds.y, n_lambdas=T, device="cpu", **SOLVE)
    (served,) = PathServer(slots=1, device="cpu", **SOLVE).serve(
        [PathJob(jid=7, X=ds.X, y=ds.y, lambdas=host.lambdas)], log=lambda *a: None)
    RefServer(slots=1, **SOLVE).serve(
        [RefJob(jid=7, X=ds.X, y=ds.y, lambdas=host.lambdas)], log=lambda *a: None)
    pt = served.extras["path_trace"]
    assert pt.engine == "serve" and not pt.walls_observed
    _assert_schema(pt, T)
    np.testing.assert_allclose([s.lam for s in pt.steps], host.lambdas)
    assert pt.total_s == pytest.approx(served.extras["latency_s"])
    assert pt.meta["jid"] == 7 and served.extras["jid"] == 7
    assert all(np.isfinite(s.solve_s) and np.isfinite(s.gap) for s in pt.steps)
    port = {n for n in _names(obs_trace) if n.startswith("serve.")}
    ref = {n for n in _names(ref_trace) if n.startswith("serve.")}
    assert {"serve.refill", "serve.step"} <= ref
    assert port == ref | {"serve.solve"}
