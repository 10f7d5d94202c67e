"""The metric arithmetic: the interval union behind ``device_idle``, the
counts behind ``path_mfu`` and ``sweep_roofline`` on a known path, shares
that cannot pass 100%, and the readers on a hand-made run."""

import importlib
import numpy as np
import pytest

from svmbench.harness import loop, profile, roofline


def test_union_and_gaps_on_hand_made_intervals():
    iv = [(5, 8), (0, 2), (1, 3), (7, 9), (12, 20)]
    assert profile.union_length(iv, 0, 10) == 3 + 4
    assert profile.union_length(iv, 2.5, 14) == 0.5 + 4 + 2
    assert profile.idle_intervals(iv, 0, 10) == [(3, 5), (9, 10)]
    assert profile.idle_intervals(iv, -1, 30) == [(-1, 0), (3, 5), (9, 12), (20, 30)]
    assert profile.idle_intervals([], 0, 1) == [(0, 1)]
    assert profile.idle_intervals([(50, 60)], 0, 10) == [(0, 10)]


RECORD = {"iters": np.array([0, 10, 20]), "kept": np.array([0, 5, 7]),
          "kept_samples": np.array([0, 100, 0])}
M, N = 10, 200


def test_counts_on_a_known_path():
    sweeps = 2 * (10 * 5 * 100 + 20 * 7 * 200)
    assert roofline.sweep_elements(RECORD, N) == sweeps
    assert roofline.screen_elements(RECORD, M, N) == 2 * M * N
    assert roofline.sweep_bound_s(RECORD, N, 4) == pytest.approx(sweeps * 4 / 3.35e12)
    assert roofline.path_bound_s(RECORD, M, N, 4) == pytest.approx(
        (sweeps + 2 * M * N) * 4 / 3.35e12)
    assert roofline.kept_share(RECORD, M, N) == pytest.approx(
        (0 * N + 5 * 100 + 7 * 200) / (3 * M * N))


@pytest.mark.parametrize("seed", range(20))
def test_shares_cannot_pass_100(seed):
    rng = np.random.default_rng(seed)
    m, n, T = int(rng.integers(1, 5000)), int(rng.integers(1, 5000)), int(rng.integers(1, 30))
    rec = {"iters": rng.integers(0, 4000, T), "kept": rng.integers(0, m + 1, T),
           "kept_samples": rng.integers(0, n + 1, T)}
    assert 0.0 <= roofline.kept_share(rec, m, n) <= 1.0
    # every count the shapes allow is at most full-width sweeps and screens,
    # which no correct implementation can read faster than the bound
    full = (2.0 * np.sum(rec["iters"]) + max(T - 1, 0)) * m * n * 4
    assert roofline.path_bound_s(rec, m, n, 4) <= full / roofline.HBM_BYTES_PER_S * (1 + 1e-12)
    assert roofline.sweep_bound_s(rec, n, 4) <= roofline.path_bound_s(rec, m, n, 4)


def reader(name):
    return importlib.import_module(f"svmbench.metrics.{name}")


def hand_run(trace=None, traced=0):
    run = loop.Run(m=M, n=N, elem_bytes=4, setup_s=12.5,
                   window_s=8.0, records=[dict(RECORD, solve_s=0.3)] * 4,
                   attempted=4, peak_window_bytes=3 * 2 ** 30, trace=trace, traced=traced)
    return run


def test_readers_without_a_trace():
    run = hand_run()
    assert reader("paths_per_s").read(run) == 0.5
    assert reader("peak_gib").read(run) == 3.0
    assert reader("setup_s").read(run) == 12.5
    assert reader("iters_per_path").read(run) == 30.0
    assert reader("iter_ms").read(run) == pytest.approx(1e3 * 0.3 / 30)
    assert reader("kept_share").read(run) == pytest.approx(
        100 * roofline.kept_share(RECORD, M, N))
    for name in ("path_mfu", "sweep_roofline", "device_idle"):
        assert reader(name).read(run) is None


def test_readers_on_a_trace():
    t = profile.TraceSummary(window_s=2.0, busy_s=1.5, kernel_s={
        "void margin_partial_bulk<float, 4>(...)": 1e-6, "hinge_grad_scalar<float>": 2e-6,
        "gemv2T_kernel_val": 5.0})
    run = hand_run(t, traced=2)
    assert reader("device_idle").read(run) == pytest.approx(25.0)
    sweep = 2 * roofline.sweep_bound_s(RECORD, N, 4)
    assert reader("sweep_roofline").read(run) == pytest.approx(100 * sweep / 3e-6)
    path = 2 * roofline.path_bound_s(RECORD, M, N, 4)
    assert reader("path_mfu").read(run) == pytest.approx(100 * path / 2.0)
    assert reader("kept_share").read(run) is not None
    t.kernel_s = {"gemv2T_kernel_val": 5.0}
    assert reader("sweep_roofline").read(run) is None


def _ev(name, kind, a, b, annotation=False):
    return profile.Event(name, kind, a, b, annotation)


def test_summary_of_a_hand_made_trace():
    events = [
        _ev(profile.WINDOW, "CPU", 0, 100, True),
        _ev("path.solve", "CPU", 10, 90),          # known by name
        _ev("aten::item", "CPU", 40, 60),
        _ev("path.solve", "CUDA", 10, 90, True),   # the annotation's device copy
        _ev("other.span", "CUDA", 0, 100, True),
        _ev("hinge_grad", "CUDA", 0, 30),
        _ev("hinge_grad", "CUDA", 20, 40),
        _ev("Memcpy DtoH", "CUDA", 70, 80),
        _ev("late", "CUDA", 95, 120),
    ]
    s = profile.summarize(events, {"path.solve"})
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((40 + 10 + 5) * 1e-6)
    assert s.kernel_s["hinge_grad"] == pytest.approx(50e-6)
    assert s.kernel_s["late"] == pytest.approx(5e-6)
    labels = dict(s.idle_gaps)
    assert labels["path.solve > aten::item"] == pytest.approx(30e-6)   # 40..70
    assert labels["path.solve"] == pytest.approx(15e-6)                # 80..95 at 87.5
    assert sum(labels.values()) == pytest.approx(45e-6)
    assert profile.summarize(events[1:], {"path.solve"}) is None


def test_events_of_a_cpu_profile():
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(profile.WINDOW):
            torch.ones(8).add_(1)
    evs = profile.events(prof)
    win = [e for e in evs if e.name == profile.WINDOW]
    assert len(win) == 1 and win[0].device == "CPU" and win[0].annotation
    assert all(e.end >= e.start for e in evs)
    assert any(e.name.startswith("aten::") and e.start >= win[0].start for e in evs)
    s = profile.summarize(evs, set())
    assert s.busy_s == 0.0 and s.window_s > 0 and s.idle_gaps == []
