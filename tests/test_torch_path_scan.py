"""The port's on-device path engines (``core/path_scan.py``) and the FISTA
loop decided on the device (``core/solver.py`` ``fista_run``) against the
reference and against the port's host loop.

Inputs are made with numpy (``make_sparse_classification``, the
reference's stock 300 x 120 instance, seed 41) and handed to both
packages, with the same L (the port's estimate: the reference's 30 power
iterations stop lower). Tolerances:

* ``fista_run`` against the port's host-loop ``fista_solve``: the same
  fp32 operations in the same order, so the same iteration count and the
  objective to rel 1e-7;
* paths at fixed FISTA iterations (``tol=-1``, 300 a step, where the solves
  sit at the fp32 floor): objectives rel 1e-6 against the reference's host
  path (the reference's own host-vs-scan spread is 7.9e-6), weights atol
  1e-4, kept counts and compact capacities equal to the reference's scan
  engine's; batched elements against the single-path engine rel 1e-6;
* ``exact_lipschitz`` at the default stop rule: rel 1e-5 (each package
  estimates its own L per step);
* safety exact: no feature that the unscreened path makes nonzero is
  screened.

The reference's engines run jitted on the CPU; its scan program is called
with an explicit L. Module-scope fixtures keep each path to one run.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import path_scan as ref_scan
from repro.core.dual import bias_at_lambda_max as ref_bias
from repro.core.dual import lambda_max as ref_lambda_max
from repro.core.dual import theta_at_lambda_max as ref_theta_max
from repro.core.path import PathDriver as RefDriver
from repro_torch.core import path_scan, solver
from repro_torch.core.path import PathDriver, svm_path
from repro_torch.core.path_scan import (
    _batched_path_step,
    _batched_statics,
    compact_caps,
    compact_caps_batched,
    svm_path_batched,
    svm_path_scan,
)
from repro_torch.core.solver import (
    CHUNK_ITERS,
    HEALTH_SCREEN_REFUSED,
    fista_run,
    fista_solve,
    lipschitz_estimate,
)
from repro_torch.core.rules.programs import resolve_programs
from repro_torch.data import make_sparse_classification
from repro_torch.kernels import hinge, ops
from repro_torch.launch.train_svm import main as train_main

GRID = dict(n_lambdas=6, lam_min_ratio=0.15)
FIXED = dict(tol=-1.0, max_iters=300)
RULES = ["feature_vi", "edpp", "dvi", "auto"]
TAU = 1.0 - 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its tensors are small, and the
    suite runs several workers at once, whose thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return make_sparse_classification(m=300, n=120, k_active=10, seed=41)


@pytest.fixture(scope="module")
def L(ds):
    return float(lipschitz_estimate(torch.from_numpy(ds.X)))


@pytest.fixture(scope="module")
def ref_host(ds, L):
    """The reference's host paths at fixed iterations, one per rule."""
    return {rules: RefDriver(rules=rules, L=L, **FIXED).run(ds.X, ds.y, **GRID)
            for rules in RULES}


@pytest.fixture(scope="module")
def scan_paths(ds, L):
    """The port's scan paths at fixed iterations, by (reduce, rules)."""
    return {(reduce, rules): svm_path_scan(ds.X, ds.y, reduce=reduce, rules=rules,
                                           L=L, device="cpu", **FIXED, **GRID)
            for reduce in ("mask", "compact") for rules in RULES}


@pytest.fixture(scope="module")
def unscreened(ds, L):
    return svm_path_scan(ds.X, ds.y, screening=False, L=L, device="cpu",
                         **FIXED, **GRID)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.maximum(np.abs(np.asarray(b)), 1.0)))


# -- compact buckets -------------------------------------------------------------


@pytest.mark.parametrize("m", [16, 64, 300, 2000, 50_000, 10**6])
def test_compact_caps_match_reference(m):
    assert compact_caps(m) == ref_scan.compact_caps(m)
    assert compact_caps_batched(m) == ref_scan.compact_caps_batched(m)
    for kept in ([0], [5], [10, 40], [m // 3, 1], [m // 2], [m], []):
        assert (compact_caps_batched(m, kept)
                == ref_scan.compact_caps_batched(m, kept)), kept


# -- fista_run -------------------------------------------------------------------


def _inv_L(L):
    Lf = max(np.float32(L) * np.float32(1.01), np.float32(1e-12))
    return float(np.float32(1.0) / Lf)


@pytest.mark.parametrize("case", ["plain", "sample_mask", "feature_mask"])
@pytest.mark.parametrize("ratio", [0.5, 0.1])
def test_fista_run_matches_host_loop(ds, L, case, ratio):
    """Same iterations and objective as the host loop on one L: the sample
    mask drops a third of the columns, the feature mask freezes half the
    rows (the host loop solves on ``X * mask``)."""
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    lam = ratio * float(ref_lambda_max(jnp.asarray(ds.X), jnp.asarray(ds.y)))
    rng = np.random.default_rng(3)
    sm = fm = None
    Xh = X
    if case == "sample_mask":
        sm = torch.from_numpy((rng.random(120) < 0.67).astype(np.float32))
    if case == "feature_mask":
        fm = torch.from_numpy((rng.random(300) < 0.5).astype(np.float32))
        Xh = X * fm[:, None]
    host = fista_solve(Xh, y, lam, L=L, sample_mask=sm, max_iters=3000)
    run = fista_run(X, y, lam, torch.zeros(300), torch.mean(y), _inv_L(L), sm, fm,
                    max_iters=3000, tol=1e-9)
    assert int(run.n_iters) == host.n_iters
    assert abs(float(run.obj) - host.obj) <= 1e-7 * abs(host.obj)
    assert bool(run.converged) == host.converged and int(run.health) == host.health
    np.testing.assert_allclose(run.w.numpy(), host.w.numpy(), atol=1e-6)


def test_fista_run_fetches_once_a_chunk(ds, L):
    """One ``go`` fetch a chunk of CHUNK_ITERS iterations (the last chunk
    holds the stop), and no per-iteration fetch."""
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    before = dict(solver.FETCHES)
    res = fista_run(X, y, 2.0, torch.zeros(300), torch.mean(y), _inv_L(L),
                    max_iters=3000, tol=1e-9)
    got = {k: solver.FETCHES[k] - before[k] for k in before}
    n = int(res.n_iters)
    assert n > 2 * CHUNK_ITERS
    assert got["chunk"] == n // CHUNK_ITERS + 1
    assert sum(got.values()) == got["chunk"]


def test_scan_path_fetches_once_a_step_and_chunk(scan_paths):
    """A scan path's host fetches: one a step, one a chunk of every solve,
    one to set up and one for the result; never one an iteration."""
    for key, r in scan_paths.items():
        f = r.extras["host_fetches"]
        T = len(r.lambdas)
        assert f["host_loop"] == f["segment"] == 0, key
        assert f["step"] == T and f["setup"] == 1 and f["result"] == 1, key
        bound = sum(int(k) // CHUNK_ITERS + 1 for k in r.solver_iters)
        assert f["chunk"] <= bound, key
        assert sum(f.values()) < int(r.solver_iters.sum()) / 4, key


def test_restart_sweeps_work_only_when_a_restart_fires(ds, L, monkeypatch):
    """The restart's two sweeps are predicated launches: over a solve, the
    gradient calls whose flag is 1 are the host loop's gradient calls (one
    an iteration, one more a restart), and the rest are switched off (on
    the card they read no X). The solve restarts at least once."""
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    lam = 0.1 * float(ref_lambda_max(jnp.asarray(ds.X), jnp.asarray(ds.y)))
    calls = []
    real = solver.hinge_grad_op
    monkeypatch.setattr(solver, "hinge_grad_op",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    host = fista_solve(X, y, lam, L=L, max_iters=3000)
    host_calls = len(calls)
    restarts = host_calls - host.n_iters
    assert restarts > 0
    calls.clear()
    ops.reset_launch_counts()
    run = fista_run(X, y, lam, torch.zeros(300), torch.mean(y), _inv_L(L),
                    max_iters=3000, tol=1e-9)
    skipped = ops.skipped_counts()
    assert int(run.n_iters) == host.n_iters
    assert len(calls) == 2 * CHUNK_ITERS * (host.n_iters // CHUNK_ITERS + 1)
    assert len(calls) - skipped["hinge_grad"] == host_calls
    assert skipped["margin_obj"] == skipped["hinge_grad"]


def test_predicated_plain_calls_count_and_compute(ds):
    """The plain versions compute whatever the flag and count a 0 flag."""
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(300).astype(np.float32))
    ops.reset_launch_counts()
    for f in (0, 1, 0):
        flag = torch.tensor(f, dtype=torch.int32)
        got = hinge.margin_obj_op(X, w, y, 0.1, flag=flag)
        for g, p in zip(got, hinge.margin_obj_plain(X, w, y, 0.1)):
            assert torch.equal(g, p)
        assert torch.equal(hinge.hinge_grad_op(X, y, got[1], flag=flag),
                           hinge.hinge_grad_plain(X, y, got[1]))
    assert ops.skipped_counts() == {"margin_obj": 2, "hinge_grad": 2}
    ops.reset_launch_counts()
    assert ops.skipped_counts() == {"margin_obj": 0, "hinge_grad": 0}


# -- the scan engine against the reference ---------------------------------------


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("reduce", ["mask", "compact"])
def test_scan_matches_reference_host_path(ds, ref_host, scan_paths, unscreened,
                                          reduce, rules):
    """At fixed iterations the scan path's objectives and weights are the
    reference host path's (same rule, same L), screened weights are exact
    zeros, every compact capacity holds its keeps, and no feature the
    unscreened path makes nonzero was screened."""
    r, ref = scan_paths[(reduce, rules)], ref_host[rules]
    assert _rel(r.objectives, ref.objectives) <= 1e-6
    np.testing.assert_allclose(r.weights, ref.weights, atol=1e-4)
    masks = r.extras["keep_masks"]
    assert np.all(r.weights[~masks] == 0.0)
    assert np.all(r.extras["caps"] >= r.kept)
    assert np.all(r.extras["health"] == 0)
    if reduce == "compact":
        assert r.extras["caps"][0] < 300
    for k in range(len(r.lambdas)):
        w = np.abs(unscreened.weights[k])
        support = w > 1e-6 * max(w.max(), 1e-30)
        assert not np.any(support & ~masks[k]), (k, int(np.sum(support & ~masks[k])))


def test_scan_keeps_and_caps_match_reference_scan(ds, L, scan_paths):
    """The reference's scan program (explicit L, compact, the same fixed
    iterations) keeps the same features and picks the same capacities."""
    X, y = jnp.asarray(ds.X), jnp.asarray(ds.y)
    lmax = float(ref_lambda_max(X, y))
    lams = np.geomspace(lmax, lmax * GRID["lam_min_ratio"], GRID["n_lambdas"])
    program = jax.jit(partial(
        ref_scan._path_scan_program, max_iters=FIXED["max_iters"], screening=True,
        dynamic=False, screen_every=50, use_pallas=False, exact_lipschitz=False,
        reduce="compact", rules=("feature_vi",)))
    out = program(X, y, jnp.asarray(lams, jnp.float32), jnp.zeros(300, jnp.float32),
                  ref_bias(y), ref_theta_max(y, jnp.asarray(lmax, jnp.float32)),
                  jnp.asarray(0.0, jnp.float32), jnp.asarray(lmax, jnp.float32),
                  jnp.asarray(L, jnp.float32), TAU, FIXED["tol"])
    r = scan_paths[("compact", "feature_vi")]
    np.testing.assert_array_equal(r.kept, np.asarray(out.kept))
    np.testing.assert_array_equal(r.extras["caps"], np.asarray(out.cap))
    np.testing.assert_array_equal(r.extras["keep_masks"], np.asarray(out.fmask))
    np.testing.assert_array_equal(r.extras["resurrected"], np.asarray(out.resurrected))
    assert _rel(r.objectives, np.asarray(out.obj)) <= 1e-6


def test_compact_overflow_falls_back_to_mask(ds, L):
    """Unscreened, every step keeps all m rows, past the largest bucket: the
    compact engine solves in mask mode (cap == m), as the mask engine."""
    kw = dict(screening=False, L=L, device="cpu", tol=1e-9, max_iters=4000, **GRID)
    c = svm_path_scan(ds.X, ds.y, reduce="compact", **kw)
    s = svm_path_scan(ds.X, ds.y, reduce="mask", **kw)
    assert np.all(c.extras["caps"] == 300) and np.all(c.kept == 300)
    np.testing.assert_array_equal(c.objectives, s.objectives)
    np.testing.assert_array_equal(c.solver_iters, s.solver_iters)


def test_compact_buffers_live_while_a_cached_graph_reads_them(ds, L):
    """Without a cached graph reading them (as on the CPU) a new capacity
    frees the other buffers: a compact path, run twice, leaves one buffer,
    its last capacity's; ``clear_engine_cache`` frees it."""
    path_scan.clear_engine_cache()
    kw = dict(reduce="compact", L=L, device="cpu", tol=-1.0, max_iters=20, **GRID)
    first = svm_path_scan(ds.X, ds.y, **kw)
    caps = [c for c in first.extras["caps"].tolist() if c < 300]
    assert len(set(caps)) > 1  # the path crossed capacities
    held = list(path_scan._COMPACT_BUFFERS.values())
    assert len(held) == 1 and held[0].shape == (caps[-1], ds.X.shape[1])
    again = svm_path_scan(ds.X, ds.y, **kw)
    np.testing.assert_array_equal(again.objectives, first.objectives)
    del held
    held = list(path_scan._COMPACT_BUFFERS.values())
    assert len(held) == 1 and held[0].shape == (caps[-1], ds.X.shape[1])
    assert path_scan.clear_engine_cache() == {
        "graphs": 0, "buffers": 1, "buffer_bytes": held[0].numel() * 4}
    assert path_scan._COMPACT_BUFFERS == {} and path_scan.engine_cache_info() == []


@pytest.mark.parametrize("poison", ["delta_inf", "theta_nan"])
def test_poisoned_anchor_keeps_every_feature(ds, L, poison):
    """A step from a refused anchor keeps all features: an infinite delta
    (a refused certificate) sets HEALTH_SCREEN_REFUSED; a NaN theta with a
    finite delta gives NaN bounds, which the NaN-safe keep keeps."""
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    lmax = float(ref_lambda_max(jnp.asarray(ds.X), jnp.asarray(ds.y)))
    theta = ((1.0 - y * torch.mean(y)) / lmax)[None]
    delta = torch.zeros((1,))
    if poison == "delta_inf":
        delta[0] = float("inf")
    else:
        theta[0, 7] = float("nan")
    carry = (torch.zeros((1, 300)), torch.mean(y)[None], theta, delta,
             torch.tensor([lmax]), torch.ones((1, 300)))
    _, out = _batched_path_step(
        X, y, None, _batched_statics(X, y, None, True), torch.tensor([_inv_L(L)]),
        TAU, 1e-9, carry, torch.tensor([0.5 * lmax]), torch.ones(1, dtype=torch.bool),
        caps=compact_caps(300), shared_x=True, max_iters=500, screening=True,
        dynamic=False, screen_every=50, exact_lipschitz=False)
    assert int(out.kept[0]) == 300 and int(out.cap[0]) == 300
    refused = bool(int(out.health[0]) & HEALTH_SCREEN_REFUSED)
    assert refused == (poison == "delta_inf")
    assert bool(torch.isfinite(out.obj).all())


def test_exact_lipschitz_matches_reference(ds):
    """Each package re-estimates L on every step's reduced matrix (30 power
    iterations in the reference, 100 here): objectives rel 1e-5."""
    ref = ref_scan.svm_path_scan(ds.X, ds.y, exact_lipschitz=True, tol=1e-11,
                                 max_iters=20000, **GRID)
    for reduce in ("mask", "compact"):
        r = svm_path_scan(ds.X, ds.y, exact_lipschitz=True, reduce=reduce, tol=1e-11,
                          max_iters=20000, device="cpu", **GRID)
        assert r.extras["options"]["exact_lipschitz"]
        assert _rel(r.objectives, ref.objectives) <= 1e-5, reduce


@pytest.mark.parametrize("reduce", ["mask", "compact"])
def test_dynamic_scan_matches_reference_host_path(ds, L, ref_host, reduce):
    """dynamic=True on the scan engine: the refresh between segments of 25
    iterations on the device; at fixed iterations the objectives are the
    reference host path's. One fetch a segment."""
    r = svm_path_scan(ds.X, ds.y, reduce=reduce, dynamic=True, screen_every=25,
                      L=L, device="cpu", **FIXED, **GRID)
    assert _rel(r.objectives, ref_host["feature_vi"].objectives) <= 1e-6
    f = r.extras["host_fetches"]
    assert f["segment"] == len(r.lambdas) * (FIXED["max_iters"] // 25)


# -- the batched engine ------------------------------------------------------------


@pytest.mark.parametrize("reduce", ["mask", "compact"])
def test_batched_grids_match_single(ds, L, reduce):
    """B = 2 grids on one X: each element is the single-path engine's path at
    fixed iterations, and every step's capacity is the shared one the
    batch's kept counts select."""
    lmax = float(ref_lambda_max(jnp.asarray(ds.X), jnp.asarray(ds.y)))
    grids = np.stack([np.geomspace(lmax, lmax * r, 5) for r in (0.15, 0.4)])
    kw = dict(reduce=reduce, L=L, device="cpu", **FIXED)
    batched = svm_path_batched(ds.X, ds.y, lambdas=grids, **kw)
    assert len(batched) == 2 and batched[0].extras["batch"] == 2
    for i, b in enumerate(batched):
        single = svm_path_scan(ds.X, ds.y, lambdas=grids[i], **kw)
        assert _rel(b.objectives, single.objectives) <= 1e-6, i
        np.testing.assert_array_equal(b.kept, single.kept)
    kept = np.stack([b.kept for b in batched])
    want = ([compact_caps_batched(300, kept[:, k]) for k in range(5)]
            if reduce == "compact" else [300] * 5)
    for b in batched:
        np.testing.assert_array_equal(b.extras["caps"], want)


@pytest.mark.parametrize("reduce", ["mask", "compact"])
def test_batched_problems_match_single(L, reduce):
    """B = 2 problems (seeds 51, 52), each on its own grid from its own
    lambda_max: each element is its single-path run at fixed iterations,
    and the steps share the capacity the batch's kept counts select."""
    sets = [make_sparse_classification(m=200, n=90, k_active=8, seed=s) for s in (51, 52)]
    Xb, yb = np.stack([d.X for d in sets]), np.stack([d.y for d in sets])
    kw = dict(reduce=reduce, device="cpu", n_lambdas=5, lam_min_ratio=0.25, **FIXED)
    Ls = [float(lipschitz_estimate(torch.from_numpy(d.X))) for d in sets]
    batched = svm_path_batched(Xb, yb, L=torch.tensor(Ls), **kw)
    for i, d in enumerate(sets):
        single = svm_path_scan(d.X, d.y, L=Ls[i], **kw)
        assert _rel(batched[i].objectives, single.objectives) <= 1e-6, i
        np.testing.assert_array_equal(batched[i].extras["keep_masks"],
                                      single.extras["keep_masks"])
    kept = np.stack([b.kept for b in batched])
    want = ([compact_caps_batched(200, kept[:, k]) for k in range(5)]
            if reduce == "compact" else [200] * 5)
    for b in batched:
        np.testing.assert_array_equal(b.extras["caps"], want)


def test_batched_step_with_sample_mask_solves_the_unpadded_problem(ds, L):
    """``_batched_path_step`` with a 0/1 sample mask (the path server's padded
    slots) is the same step on the problem with those columns removed: the
    mask reaches the screen as its sample weights and the solver as its
    sample mask. Two steps from the reduced problem's lambda_max anchor at
    fixed iterations: the same keeps, objectives rel 1e-6."""
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    live = np.nonzero(np.random.default_rng(5).random(120) < 0.7)[0]
    idx = torch.from_numpy(live)
    sm = torch.zeros(120)
    sm[idx] = 1.0
    Xr, yr = X[:, idx].contiguous(), y[idx]
    lmax = float(ref_lambda_max(jnp.asarray(Xr.numpy()), jnp.asarray(yr.numpy())))
    b0 = torch.mean(yr)
    theta_r = (1.0 - yr * b0) / lmax
    theta = torch.zeros(120)
    theta[idx] = theta_r

    def steps(X_, y_, sm_, theta_):
        smb = None if sm_ is None else sm_[None]
        statics = _batched_statics(X_[None], y_[None], smb, False)
        carry = (torch.zeros((1, 300)), b0[None], theta_[None], torch.zeros((1,)),
                 torch.tensor([lmax]), torch.ones((1, 300)))
        outs = []
        for ratio in (0.8, 0.6):
            carry, out = _batched_path_step(
                X_[None], y_[None], smb, statics, torch.tensor([_inv_L(L)]), TAU,
                -1.0, carry, torch.tensor([ratio * lmax]),
                torch.ones(1, dtype=torch.bool), caps=compact_caps(300),
                shared_x=False, max_iters=300, screening=True, dynamic=False,
                screen_every=50, exact_lipschitz=False)
            outs.append(out)
        return outs

    for g, w in zip(steps(X, y, sm, theta), steps(Xr, yr, None, theta_r)):
        np.testing.assert_array_equal(g.fmask.numpy(), w.fmask.numpy())
        assert int(g.cap[0]) == int(w.cap[0]) < 300
        assert _rel(g.obj.numpy(), w.obj.numpy()) <= 1e-6
        np.testing.assert_allclose(g.w.numpy(), w.w.numpy(), atol=1e-4)


@pytest.mark.parametrize("rules", ["edpp", "auto"])
def test_batched_problems_with_sample_mask_run_edpp(rules):
    """B = 2 problems padded to one width under a 0/1 sample mask (the path
    server's slots) with ``edpp`` (and ``auto``, which resolves to it): the
    screen takes the feature screen's weighted EDPP mode, and each element
    is its unpadded problem's single path at fixed iterations (objectives
    rel 1e-6, the same keep masks). Before the weighted mode this raised."""
    sets = [make_sparse_classification(m=200, n=n, k_active=8, seed=s)
            for s, n in ((61, 90), (62, 70))]
    B, m, n_b = 2, 200, 96
    X = torch.zeros((B, m, n_b))
    y, sm, theta0 = torch.zeros((B, n_b)), torch.zeros((B, n_b)), torch.zeros((B, n_b))
    Ls, lmaxs, grids = [], [], []
    for e, d in enumerate(sets):
        n = d.X.shape[1]
        X[e, :, :n], y[e, :n], sm[e, :n] = torch.from_numpy(d.X), torch.from_numpy(d.y), 1.0
        lmax = float(ref_lambda_max(jnp.asarray(d.X), jnp.asarray(d.y)))
        theta0[e, :n] = (1.0 - y[e, :n] * torch.mean(y[e, :n])) / lmax
        Ls.append(float(lipschitz_estimate(torch.from_numpy(d.X))))
        lmaxs.append(lmax)
        grids.append(np.geomspace(lmax, 0.25 * lmax, 5))
    before = ops.launch_counts()["screen_bounds_edpp_weighted"]
    outs = path_scan._batched_path_scan_program(
        X, y, sm, torch.as_tensor(np.stack(grids), dtype=torch.float32),
        torch.zeros(m), torch.stack([torch.mean(y[e, :d.X.shape[1]])
                                     for e, d in enumerate(sets)]),
        theta0, torch.zeros(()), torch.tensor(lmaxs), torch.tensor(Ls), TAU,
        -1.0, max_iters=300, screening=True, dynamic=False, screen_every=50,
        exact_lipschitz=False, reduce="compact", rules=resolve_programs(rules))
    assert ops.launch_counts()["screen_bounds_edpp_weighted"] == before  # plain on the CPU
    for e, d in enumerate(sets):
        single = svm_path_scan(d.X, d.y, lambdas=grids[e], rules=rules, reduce="compact",
                               L=Ls[e], tau=TAU, device="cpu", **FIXED)
        assert _rel(outs.obj[e].numpy(), single.objectives) <= 1e-6, e
        np.testing.assert_array_equal(outs.fmask[e].numpy(), single.extras["keep_masks"])


def test_batched_step_skips_elements_not_live(ds, L, monkeypatch):
    """An element marked not live (an empty server slot) is neither
    screened, solved nor certified: it reports zeros
    and keeps every feature, and the live element's outputs are bit for bit
    those of the step with both elements live."""
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    Xb, yb = torch.stack([X, X]), torch.stack([y, y])
    lmax = float(ref_lambda_max(jnp.asarray(ds.X), jnp.asarray(ds.y)))
    theta = ((1.0 - y * torch.mean(y)) / lmax).expand(2, -1).clone()
    carry = (torch.zeros((2, 300)), torch.mean(y).expand(2).clone(), theta,
             torch.zeros((2,)), torch.full((2,), lmax), torch.ones((2, 300)))
    screens = []
    stack_bounds = path_scan._stack_bounds
    monkeypatch.setattr(path_scan, "_stack_bounds",
                        lambda *a, **k: screens.append(1) or stack_bounds(*a, **k))

    def step(act):
        _, out = _batched_path_step(
            Xb, yb, None, _batched_statics(Xb, yb, None, False),
            torch.full((2,), _inv_L(L)), TAU, 1e-9, carry,
            torch.full((2,), 0.5 * lmax), act, caps=compact_caps(300),
            shared_x=False, max_iters=200, screening=True, dynamic=False,
            screen_every=50, exact_lipschitz=False)
        return out

    both = step([True, True])
    assert len(screens) == 2
    one = step([True, False])
    assert len(screens) == 3
    for f in ("w", "obj", "fmask", "kept", "n_iters", "gap", "delta"):
        np.testing.assert_array_equal(getattr(one, f)[0].numpy(),
                                      getattr(both, f)[0].numpy(), err_msg=f)
    assert bool(one.fmask[1].all()) and int(one.n_iters[1]) == 0
    assert float(one.obj[1]) == 0.0 and int(one.cap[0]) == int(both.cap[0])


def test_batched_validation_errors(ds):
    with pytest.raises(ValueError, match="lambdas"):
        svm_path_batched(ds.X, ds.y, device="cpu")  # 2-D X needs (B, T) grids
    with pytest.raises(ValueError, match="B, T"):
        svm_path_batched(ds.X, ds.y, lambdas=np.array([0.5, 0.1]), device="cpu")
    Xb = np.stack([ds.X, ds.X])
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        svm_path_batched(Xb, ds.y, device="cpu")
    with pytest.raises(ValueError, match=r"\(m, n\) or \(B, m, n\)"):
        svm_path_batched(ds.X[0], ds.y, device="cpu")
    with pytest.raises(ValueError, match="decreasing"):
        svm_path_batched(ds.X, ds.y, lambdas=np.array([[0.1, 0.5]]), device="cpu")
    with pytest.raises(ValueError, match="mask' or 'compact"):
        svm_path_scan(ds.X, ds.y, reduce="gather", device="cpu")
    for rules in ("sample_vi", "composite", "sifs"):
        with pytest.raises(ValueError, match="feature rules only"):
            svm_path_scan(ds.X, ds.y, rules=rules, device="cpu")
        with pytest.raises(ValueError, match="feature rules only"):
            svm_path_batched(Xb, np.stack([ds.y, ds.y]), rules=rules, device="cpu")
    with pytest.raises(ValueError, match="scan engine"):
        PathDriver(reduce="compact", device="cpu")


# -- dispatch and the launcher -----------------------------------------------------


def test_svm_path_engine_dispatch(ds, scan_paths):
    kw = dict(device="cpu", **FIXED, **GRID)
    r = svm_path(ds.X, ds.y, engine="scan", **kw)
    assert r.extras["engine"] == "scan" and r.extras["options"]["reduce"] == "mask"
    np.testing.assert_allclose(r.objectives, scan_paths[("mask", "feature_vi")].objectives,
                               rtol=1e-6)
    rc = svm_path(ds.X, ds.y, engine="scan", reduce="compact", rules="edpp", **kw)
    assert rc.extras["options"]["reduce"] == "compact"
    assert rc.extras["options"]["rules"] == ("edpp",)
    Xb, yb = np.stack([ds.X, ds.X]), np.stack([ds.y, ds.y])
    rs = svm_path(Xb, yb, engine="batched", reduce="compact", device="cpu",
                  n_lambdas=3, lam_min_ratio=0.5, tol=-1.0, max_iters=50)
    assert isinstance(rs, list) and len(rs) == 2
    assert all(x.extras["engine"] == "batched" for x in rs)
    with pytest.raises(ValueError, match="'host', 'scan', or 'batched'"):
        svm_path(ds.X, ds.y, engine="bogus", device="cpu")
    # the host engine takes exact_lipschitz too (PathDriver's, as the
    # reference's svm_path passes it): every solve estimates its own L
    rh = svm_path(ds.X, ds.y, exact_lipschitz=True, **kw)
    want = PathDriver(exact_lipschitz=True, device="cpu", **FIXED).run(ds.X, ds.y, **GRID)
    np.testing.assert_array_equal(rh.objectives, want.objectives)
    assert path_scan.engine_cache_info() == []  # no graph on the CPU


@pytest.mark.parametrize("argv", [
    ["--engine", "scan", "--reduce", "compact"],
    ["--engine", "scan", "--rules", "dvi", "--exact-lipschitz"],
    ["--engine", "batched", "--reduce", "compact"],
])
def test_launcher_engines(argv, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the launcher writes artifacts/ here
    assert train_main(["--m", "120", "--n", "60", "--n-lambdas", "4", "--device", "cpu",
                       *argv]) == 0
    out = capsys.readouterr().out
    assert f"engine={argv[1]}" in out
    assert "step  3" in out and "host_fetches=" in out
    if argv[1] == "batched":  # two problems, seeds --seed and --seed + 1
        assert "seed=0 " in out and "seed=1 " in out


def test_launcher_rejects_compact_on_the_host_engine():
    with pytest.raises(SystemExit):
        train_main(["--m", "40", "--n", "20", "--reduce", "compact", "--device", "cpu"])
