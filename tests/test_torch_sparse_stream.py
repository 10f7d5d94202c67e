"""The port's out-of-core storage (``repro_torch.sparse``) against the
reference's ``repro.sparse`` on the same seeded data.

Instances (at most 320 x 130): the dense ``make_sparse_classification``
problem of the reference's own tests (300 x 130, seed 21), its density-0.04
CSR twin (seed 23) and the planted instance (320 x 120, seed 7, rows past
64 scaled by 0.05, so whole tail chunks screen out and stay dead). The
reference runs its XLA route (``use_pallas=False``), except one case of
its Pallas route in interpret mode.

Tolerances, each with its reason:

* bit for bit: the port's streamed feature screen against its in-core
  screen (the kernel's plain version reduces each row on its own; on the
  card the kernel sums a row in an order that does not depend on m), the
  chunk-skip path against its full-stream twin, CSR chunks densified for
  the screen against the dense chunking, the memmap store against the
  in-memory container, and paths whose gathered solves are the in-core
  path's;
* rtol 1e-4, atol 1e-4 of the scale: fp32 reductions taken in another
  order (the reference's row-stable XLA sums and BCOO products, chunk
  partials); the reference's own BCOO tolerance is 2e-4;
* rel 1e-5 on objectives: the streamed solver and paths against the
  reference and against the port's dense solver at fixed iterations (the
  reference's host and scan engines differ by up to 7.9e-6 themselves);
* rel 1e-6 on lambda_max and L: one max or norm of fp32 sums in another
  order.
"""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as ref_sparse
from repro.core import PathDriver as RefDriver
from repro.core.screening import fixed_stats as ref_fixed_stats
from repro.data import load_libsvm as ref_load_libsvm
from repro_torch.core.dual import lambda_max, theta_at_lambda_max
from repro_torch.core.path import PathDriver, svm_path
from repro_torch.core.screening import (
    SAFE_TAU,
    anchor_slice,
    anchor_stats,
    d_theta_sparse,
    finalize_from_anchor,
    fixed_slice,
    fixed_stats,
    screen_bounds,
)
from repro_torch.core.solver import fista_solve, lipschitz_estimate
from repro_torch.data import iter_libsvm, load_libsvm, make_sparse_classification
from repro_torch.launch.train_svm import main as launcher
from repro_torch.sparse import (
    ChunkScreenCache,
    FeatureChunked,
    StoreCorruptError,
    StoreError,
    StoreMissingError,
    fista_solve_chunked,
    fixed_reductions,
    gap_theta_delta_stream,
    lambda_max_stream,
    lipschitz_estimate_stream,
    screen_step_stream,
    screen_stream,
    stream_feature_reductions,
    stream_sample_stats,
)
from repro_torch.sparse import chunked as port_chunked

REL = 1e-5


def _close(got, want, rtol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors are small, and the suite runs
    several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dense_inst():
    return make_sparse_classification(m=300, n=130, k_active=12, seed=21)


@pytest.fixture(scope="module")
def sparse_inst():
    return make_sparse_classification(m=300, n=130, k_active=12, seed=23,
                                      density=0.04)


@pytest.fixture(scope="module")
def planted_inst():
    ds = make_sparse_classification(m=320, n=120, k_active=8, seed=7)
    X = np.array(ds.X, copy=True)
    X[64:] *= 0.05
    return X, np.asarray(ds.y)


def _anchor(ds):
    """The exact anchor at lambda_max: ``(y, lmax, theta)`` on the CPU."""
    X, y = _t(ds.X), _t(ds.y)
    lmax = float(lambda_max(X, y))
    return y, lmax, theta_at_lambda_max(y, lmax)


# -- the container ----------------------------------------------------------

@pytest.mark.parametrize("storage", ["dense", "csr"])
def test_container_matches_reference(sparse_inst, storage):
    """Offsets, the dense view, gathers, and the column and row norms
    against the reference's container on the same chunking."""
    ds = sparse_inst
    make = (lambda cls: cls.from_dense(ds.X, chunk_m=97)) if storage == "dense" \
        else (lambda cls: cls.from_csr(ds.csr, chunk_m=97))
    fc, ref = make(FeatureChunked), make(ref_sparse.FeatureChunked)
    np.testing.assert_array_equal(fc.offsets, ref.offsets)
    np.testing.assert_array_equal(fc.as_dense(), ref.as_dense())
    np.testing.assert_array_equal(fc.as_dense(), ds.X)
    assert fc.shape == ds.X.shape and fc.n_chunks == 4
    idx = np.asarray([0, 5, 96, 97, 299, 150, 5])
    np.testing.assert_array_equal(fc.gather_rows(idx), ref.gather_rows(idx))
    _close(fc.col_sq("cpu"), ref.col_sq())
    _close(fc.row_sq("cpu"), ref.row_sq())
    assert fc.col_sq("cpu") is fc.col_sq("cpu")  # theta-independent: memoized


def test_gather_rows_matches_the_row_loop(sparse_inst):
    """The vectorised CSR gather against the reference's per-row loop, on
    rows in any order, repeated, and rows with no stored value."""
    ds = sparse_inst
    fc = FeatureChunked.from_csr(ds.csr, chunk_m=64)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 300, size=200)
    empty = np.nonzero(np.diff(ds.csr.indptr) == 0)[0][:3]
    idx = np.concatenate([idx, empty, idx[:5]])
    loop = np.zeros((len(idx), fc.n), np.float32)
    for dst, r in enumerate(idx):
        lo, hi = ds.csr.indptr[r], ds.csr.indptr[r + 1]
        loop[dst, ds.csr.indices[lo:hi]] = ds.csr.data[lo:hi]
    np.testing.assert_array_equal(fc.gather_rows(idx), loop)


def test_matvec_pair_matches_dense(sparse_inst):
    """matvec / rmatvec over dense chunks and CSR chunks (written densely
    on the device), live chunks only, against the in-core products."""
    ds = sparse_inst
    X = _t(ds.X)
    rng = np.random.default_rng(3)
    v = _t(rng.standard_normal(130).astype(np.float32))
    w = _t(rng.standard_normal(300).astype(np.float32))
    live = np.array([True, False, True, True, False])
    for fc in (FeatureChunked.from_dense(ds.X, chunk_m=64),
               FeatureChunked.from_csr(ds.csr, chunk_m=64)):
        _close(fc.matvec(v), X @ v)
        _close(fc.rmatvec(w), X.t() @ w)
        rows = np.repeat(live, np.diff(fc.offsets))
        _close(fc.matvec(v, live_chunks=live), (X @ v) * _t(rows))
        _close(fc.rmatvec(w * _t(rows), live_chunks=live), X.t() @ (w * _t(rows)))
        assert fc.stats["chunks_skipped"] == 4


# -- the streamed screen ----------------------------------------------------

@pytest.mark.parametrize("chunk_m", [97, 300])
@pytest.mark.parametrize("inexact", [False, True], ids=["exact", "delta"])
def test_stream_bounds_match_in_core_and_reference(dense_inst, chunk_m, inexact):
    """The streamed VI bounds equal the port's in-core bounds bit for bit,
    and the reference's streamed bounds (XLA route) to fp32 tolerance; an
    inexact anchor (delta > 0) goes through the same scalars."""
    ds = dense_inst
    y, lmax, theta = _anchor(ds)
    lam1, delta = lmax, 0.0
    if inexact:
        lam1, delta = 0.5 * lmax, 0.013
        theta = _t(np.random.default_rng(5).random(130).astype(np.float32)) / lam1
    fc = FeatureChunked.from_dense(ds.X, chunk_m=chunk_m)
    keep, bounds = screen_stream(fc, y, lam1, 0.6 * lam1, theta, delta=delta)
    want = screen_bounds(_t(ds.X), y, lam1, 0.6 * lam1, theta, delta=delta)
    assert torch.equal(bounds, want)
    assert torch.equal(keep, ~(want < SAFE_TAU))
    ref = ref_sparse.FeatureChunked.from_dense(ds.X, chunk_m=chunk_m)
    _, rb = ref_sparse.screen_stream(ref, ds.y, lam1, 0.6 * lam1,
                                     jnp.asarray(theta.numpy()), delta=delta,
                                     use_pallas=False)
    _close(bounds, rb)


def test_stream_bounds_match_reference_pallas_route(dense_inst):
    """One small case of the reference's Pallas route (interpret mode):
    its per-chunk fused kernel against the port's streamed bounds."""
    ds = dense_inst
    y, lmax, theta = _anchor(ds)
    fc = FeatureChunked.from_dense(ds.X, chunk_m=150)
    _, bounds = screen_stream(fc, y, lmax, 0.7 * lmax, theta)
    ref = ref_sparse.FeatureChunked.from_dense(ds.X, chunk_m=150)
    rb = ref_sparse.screen_bounds_stream(ref, ds.y, lmax, 0.7 * lmax,
                                         jnp.asarray(theta.numpy()),
                                         use_pallas=True)
    _close(bounds, rb)


def test_stream_reductions_and_d_theta(dense_inst):
    """The four streamed reductions against the reference's, and the
    screen's d_theta output against the streamed one."""
    ds = dense_inst
    y, lmax, theta = _anchor(ds)
    fc = FeatureChunked.from_dense(ds.X, chunk_m=97)
    red = stream_feature_reductions(fc, y, theta)
    ref = ref_sparse.stream_feature_reductions(
        ref_sparse.FeatureChunked.from_dense(ds.X, chunk_m=97), ds.y,
        jnp.asarray(theta.numpy()))
    for a, b in zip(red, ref):
        _close(a, b)
    sup = int((theta != 0).sum())
    _close(d_theta_sparse(_t(ds.X), y, theta, sup), red.d_theta)


def test_lambda_max_stream(dense_inst, sparse_inst):
    """The streamed lambda_max against the in-core one and the reference's
    streamed one (rel 1e-6: one max over fp32 sums in another order)."""
    for ds, make in ((dense_inst, lambda c: c.from_dense(dense_inst.X, chunk_m=97)),
                     (sparse_inst, lambda c: c.from_csr(sparse_inst.csr, chunk_m=97))):
        got = float(lambda_max_stream(make(FeatureChunked), _t(ds.y)))
        assert got == pytest.approx(float(lambda_max(_t(ds.X), _t(ds.y))), rel=1e-6)
        ref = float(ref_sparse.lambda_max_stream(make(ref_sparse.FeatureChunked), ds.y))
        assert got == pytest.approx(ref, rel=1e-6)


def test_fixed_reductions_stream_once_per_y(dense_inst):
    """T screen steps cost T + 1 streams (the full-stream twin: skipping
    only lowers it): the theta-independent reductions stream once for the
    caller's y object (a new y object streams again)."""
    ds = dense_inst
    y, lmax, theta = _anchor(ds)
    fc = FeatureChunked.from_dense(ds.X, chunk_m=97)
    cache = ChunkScreenCache(fc)
    T = 3
    lam1 = lmax
    for k in range(T):
        lam2 = lam1 * 0.8
        screen_step_stream(fc, y, lam1, lam2, theta, cache=cache, skip=False)
        lam1 = lam2
    assert fc.stats["puts"] == (T + 1) * fc.n_chunks
    fixed_reductions(fc, y)
    assert fc.stats["puts"] == (T + 1) * fc.n_chunks
    fixed_reductions(fc, y.clone())
    assert fc.stats["puts"] == (T + 2) * fc.n_chunks


def test_sparse_chunk_route(sparse_inst):
    """Low-density CSR chunks go to the device as CSR parts (``csr_puts``,
    fewer bytes than the dense rows; a zero threshold densifies them on the
    host instead) and are written densely there before every sweep, so the
    screen, the reductions, the product pair and the path equal the dense
    chunking's bit for bit."""
    ds = sparse_inst
    y, lmax, theta = _anchor(ds)
    fc = FeatureChunked.from_csr(ds.csr, chunk_m=64)
    dense = FeatureChunked.from_dense(ds.X, chunk_m=64)
    _, bounds = screen_stream(fc, y, lmax, 0.6 * lmax, theta)
    assert fc.stats["csr_puts"] == fc.stats["puts"] > 0
    assert torch.equal(bounds, screen_stream(dense, y, lmax, 0.6 * lmax, theta)[1])
    assert fc.stats["bytes_put"] < dense.stats["bytes_put"] / 5
    for a, b in zip(fixed_reductions(fc, y), fixed_reductions(dense, y)):
        assert torch.equal(a, b)
    v = _t(np.random.default_rng(1).standard_normal(130).astype(np.float32))
    assert torch.equal(fc.matvec(v), dense.matvec(v))
    assert torch.equal(fc.gram_matvec(v), dense.rmatvec(dense.matvec(v)))
    kw = dict(tol=-1.0, max_iters=100, L=float(lipschitz_estimate(_t(ds.X))),
              device="cpu")
    a = PathDriver(**kw).run(FeatureChunked.from_csr(ds.csr, chunk_m=64), ds.y)
    b = PathDriver(**kw).run(FeatureChunked.from_dense(ds.X, chunk_m=64), ds.y)
    np.testing.assert_array_equal(a.objectives, b.objectives)
    hi = FeatureChunked.from_csr(ds.csr, chunk_m=64, csr_threshold=0.0)
    screen_stream(hi, y, lmax, 0.6 * lmax, theta)
    assert hi.stats["csr_puts"] == 0 and hi.stats["puts"] > 0


# -- the streamed solver and certificate -------------------------------------

@pytest.mark.parametrize("case", ["cold", "warm_sample_mask", "feature_mask"])
def test_fista_solve_chunked(dense_inst, case):
    """300 fixed iterations (tol -1: the stop rule out of play) against the
    reference's streamed solver and the port's dense solver, with the same
    L; a warm start with a sample mask; a feature mask (dead chunks never
    stream, their weights stay 0)."""
    ds = dense_inst
    X, y = _t(ds.X), _t(ds.y)
    L = float(lipschitz_estimate(X))
    lam = 0.3 * float(lambda_max(X, y))
    fc = FeatureChunked.from_dense(ds.X, chunk_m=64)
    ref_fc = ref_sparse.FeatureChunked.from_dense(ds.X, chunk_m=64)
    kw = dict(max_iters=300, tol=-1.0, L=L)
    w0 = b0 = sm = fm = None
    if case == "warm_sample_mask":
        warm = fista_solve(X, y, 0.5 * float(lambda_max(X, y)), L=L)
        w0, b0 = warm.w, float(warm.b)
        sm = np.ones(130, np.float32)
        sm[:26] = 0.0
    if case == "feature_mask":
        fm = np.zeros(300, bool)
        fm[:140] = True
    got = fista_solve_chunked(fc, y, lam, w0=w0, b0=b0,
                              sample_mask=None if sm is None else _t(sm),
                              feature_mask=fm, **kw)
    ref = ref_sparse.fista_solve_chunked(
        ref_fc, ds.y, lam, w0=None if w0 is None else jnp.asarray(w0.numpy()),
        b0=b0, sample_mask=None if sm is None else jnp.asarray(sm),
        feature_mask=fm, **kw)
    assert got.n_iters == 300 and got.health == 0
    assert got.obj == pytest.approx(float(ref.obj), rel=REL)
    Xd = X if fm is None else X * _t(fm.astype(np.float32))[:, None]
    dense = fista_solve(Xd, y, lam, w0=None if w0 is None else
                        (w0 if fm is None else w0 * _t(fm.astype(np.float32))),
                        b0=b0, sample_mask=None if sm is None else _t(sm), **kw)
    assert got.obj == pytest.approx(dense.obj, rel=REL)
    _close(got.u, X.t() @ got.w)  # the carried margins
    if fm is not None:
        assert bool((got.w[~_t(fm)] == 0).all())
        assert fc.stats["chunks_skipped"] > 0


def test_dynamic_chunked_solver(dense_inst):
    """``screen_every`` shrinks the live masks mid-solve and reaches the
    unscreened optimum (rel 1e-5); the reference's dynamic streamed solver
    agrees to the same tolerance."""
    ds = dense_inst
    X, y = _t(ds.X), _t(ds.y)
    L = float(lipschitz_estimate(X))
    lam = 0.5 * float(lambda_max(X, y))
    fc = FeatureChunked.from_dense(ds.X, chunk_m=32)
    rep = {}
    got = fista_solve_chunked(fc, y, lam, max_iters=4000, tol=1e-10, L=L,
                              screen_every=40, report=rep)
    full = fista_solve(X, y, lam, max_iters=4000, tol=1e-10, L=L)
    ref = ref_sparse.fista_solve_chunked(
        ref_sparse.FeatureChunked.from_dense(ds.X, chunk_m=32), ds.y, lam,
        max_iters=4000, tol=1e-10, L=L, screen_every=40)
    assert rep["screens"] > 0 and rep["kept"] < 300
    assert got.obj == pytest.approx(full.obj, rel=REL)
    assert got.obj == pytest.approx(float(ref.obj), rel=REL)


def test_chunked_solver_guard_and_hook(dense_inst):
    """A poisoned warm start is zeroed (one trip); a hook that poisons a
    candidate trips the guard, which rolls back and stays finite."""
    ds = dense_inst
    y = _t(ds.y)
    fc = FeatureChunked.from_dense(ds.X, chunk_m=97)
    lam = 0.4 * float(lambda_max(_t(ds.X), y))
    w0 = torch.zeros(300)
    w0[3] = float("nan")

    def hook(k, w, b, u, obj):
        return (w, b, u, float("nan")) if k == 2 else None

    res = fista_solve_chunked(fc, y, lam, w0=w0, max_iters=20, tol=-1.0,
                              L=3000.0, iteration_hook=hook)
    assert res.health == 2
    assert np.isfinite(res.obj) and bool(torch.isfinite(res.w).all())


def test_lipschitz_estimate_stream(dense_inst, sparse_inst):
    """The streamed power iteration against the in-core one (the same start
    vector and 100 iterations; rel 1e-6) and the reference's streamed one
    (30 iterations: below the true value by up to 3.5%, never above it)."""
    for ds, fc in ((dense_inst, FeatureChunked.from_dense(dense_inst.X, chunk_m=97)),
                   (sparse_inst, FeatureChunked.from_csr(sparse_inst.csr, chunk_m=97))):
        got = float(lipschitz_estimate_stream(fc, "cpu"))
        assert got == pytest.approx(float(lipschitz_estimate(_t(ds.X))), rel=1e-6)
        ref = float(ref_sparse.lipschitz_estimate_stream(
            ref_sparse.FeatureChunked.from_dense(ds.X, chunk_m=97)))
        assert 0.96 * got <= ref <= got * (1 + 1e-5)


def test_gap_certificate_matches_reference(dense_inst):
    """The streamed certificate against the reference's, with the carried
    margins, a live-chunk set and a feature mask; ``want_corr``'s d_theta
    is ``X (y theta)`` on the live chunks."""
    ds = dense_inst
    X, y = _t(ds.X), _t(ds.y)
    lam = 0.4 * float(lambda_max(X, y))
    res = fista_solve(X, y, lam, L=float(lipschitz_estimate(X)))
    fc = FeatureChunked.from_dense(ds.X, chunk_m=97)
    live = np.array([True, True, False, True])
    fm = np.repeat(live, np.diff(fc.offsets))
    w = res.w * _t(fm.astype(np.float32))
    theta, delta, d_th = gap_theta_delta_stream(
        fc, y, w, res.b, lam, live_chunks=live,
        feature_mask=_t(fm.astype(np.float32)), want_corr=True)
    rt, rd, rc = ref_sparse.gap_theta_delta_stream(
        ref_sparse.FeatureChunked.from_dense(ds.X, chunk_m=97), ds.y,
        jnp.asarray(w.numpy()), float(res.b), lam, live_chunks=live,
        feature_mask=jnp.asarray(fm.astype(np.float32)), want_corr=True)
    _close(theta, rt)
    assert float(delta) == pytest.approx(float(rd), rel=1e-3)
    _close(d_th, rc)
    _close(d_th[_t(fm)], (X @ (y * theta))[_t(fm)])


# -- chunk skipping ---------------------------------------------------------

def test_chunk_skip_bitwise_vs_full_stream(planted_inst):
    """The skipping path is the full-stream path minus transfers: equal
    objectives, weights and keeps bit for bit, strictly fewer chunks and
    bytes streamed, and some step with fewer live chunks."""
    X, y = planted_inst
    kw = dict(rules="feature_vi", tol=1e-9, max_iters=8000, device="cpu")
    grid = dict(n_lambdas=8, lam_min_ratio=0.05)
    skip = PathDriver(chunk_skip=True, **kw).run(
        FeatureChunked.from_dense(X, chunk_m=32), y, **grid)
    full = PathDriver(chunk_skip=False, **kw).run(
        FeatureChunked.from_dense(X, chunk_m=32), y, **grid)
    np.testing.assert_array_equal(skip.objectives, full.objectives)
    np.testing.assert_array_equal(skip.weights, full.weights)
    np.testing.assert_array_equal(skip.kept, full.kept)
    np.testing.assert_array_equal(skip.extras["keep_masks"], full.extras["keep_masks"])
    np.testing.assert_array_equal(skip.extras["bounds"], full.extras["bounds"])
    st, sf = skip.extras["stream_stats"], full.extras["stream_stats"]
    assert st["chunks_skipped"] > 0
    assert st["chunks_streamed"] < sf["chunks_streamed"]
    assert st["bytes_put"] < sf["bytes_put"]
    assert int(np.min(skip.extras["live_chunks"])) < 10
    assert skip.extras["chunk_skip"] and not full.extras["chunk_skip"]
    # the same decisions as the reference's skipping path (XLA route)
    ref = RefDriver("feature_vi", tol=1e-9, max_iters=8000, use_pallas=False).run(
        ref_sparse.FeatureChunked.from_dense(X, chunk_m=32), y, **grid)
    np.testing.assert_array_equal(skip.extras["live_chunks"][:3],
                                  ref.extras["live_chunks"][:3])
    np.testing.assert_allclose(skip.objectives, ref.objectives, rtol=REL)


def _gated(planted_inst, lam_targets=(0.7, 0.5)):
    X, y = planted_inst
    fc = FeatureChunked.from_dense(X, chunk_m=32)
    yt = _t(y)
    lmax = float(lambda_max_stream(fc, yt))
    theta = theta_at_lambda_max(yt, lmax)
    cache = ChunkScreenCache(fc)
    out = [screen_step_stream(fc, yt, lmax, r * lmax, theta, cache=cache)
           for r in lam_targets]
    return fc, yt, lmax, theta, cache, out


def test_skipped_chunk_bounds_safe(planted_inst):
    """Every chunk the cache declares dead has all its stamped bounds below
    tau, and a fresh sweep from the same anchor agrees: the same keeps."""
    fc, yt, lmax, theta, _, out = _gated(planted_inst)
    keep_g, bounds_g, _, live = out[1]
    assert not live.all() and live.any()
    keep_f, bounds_f = screen_stream(FeatureChunked.from_dense(planted_inst[0], chunk_m=32),
                                     yt, lmax, 0.5 * lmax, theta)
    for i in np.nonzero(~live)[0]:
        s, e = fc.chunk_bounds(int(i))
        assert bool((bounds_g[s:e] < SAFE_TAU).all())
        assert bool((bounds_f[s:e] < SAFE_TAU).all())
    assert torch.equal(keep_g, keep_f)


def test_chunk_cache_refuses_larger_targets(planted_inst):
    """A cached region certifies strictly smaller lambdas only: at a
    target >= the cached anchor's lambda every chunk is live."""
    fc, yt, lmax, _, cache, _ = _gated(planted_inst, (0.6,))
    fixed = fixed_stats(yt, *fixed_reductions(fc, yt))
    live, stale = cache.live_mask(lmax, fixed)
    assert live.all() and bool(torch.isinf(stale).all())


def test_poisoned_anchor_invalidates_its_chunks(planted_inst):
    """A non-finite anchor never becomes a cached region: the chunks it
    would refresh count as never streamed (always live, +inf bounds)."""
    fc, yt, lmax, theta, cache, _ = _gated(planted_inst, (0.7,))
    fixed = fixed_stats(yt, *fixed_reductions(fc, yt))
    live, _ = cache.live_mask(0.5 * lmax, fixed)
    assert not live.all()
    d = torch.zeros(fc.m)
    d[40] = float("nan")
    cache.refresh(anchor_stats(yt, 0.7 * lmax, theta, 0.0, d), live={0, 1, 2, 3})
    live2, stale = cache.live_mask(0.5 * lmax, fixed)
    assert live2[:4].all() and bool(torch.isinf(stale[:128]).all())
    np.testing.assert_array_equal(live2[4:], live[4:])
    with pytest.raises(ValueError, match="never streamed"):
        ChunkScreenCache(fc).d_theta_slice(0)


def test_live_mask_matches_per_chunk_evaluation(planted_inst):
    """The grouped live mask (one evaluation per cached anchor, one fetch)
    against the reference's per-chunk loop on the port's cache: the same
    decisions and the same stale bounds bit for bit, with a NaN bound
    keeping its chunk live."""
    X, y = planted_inst
    fc, yt, lmax, theta, cache, _ = _gated(planted_inst, (0.8, 0.6))
    fixed = fixed_stats(yt, *fixed_reductions(fc, yt))
    cache._d_theta[7] = cache._d_theta[7].clone()
    cache._d_theta[7][3] = float("nan")
    lam2 = 0.45 * lmax
    live, stale = cache.live_mask(lam2, fixed)
    for i in range(fc.n_chunks):
        s, e = fc.chunk_bounds(i)
        a = cache.chunk_anchor(i)
        if a is None or not lam2 < cache._lam_host[i]:
            assert live[i] and bool(torch.isinf(stale[s:e]).all())
            continue
        b = finalize_from_anchor(anchor_slice(a, 0, e - s), lam2,
                                 fixed_slice(fixed, s, e))
        assert torch.equal(stale[s:e], b) or torch.equal(
            torch.isnan(stale[s:e]), torch.isnan(b))
        assert live[i] == (not bool(torch.max(b) < SAFE_TAU))
    assert live[7]


# -- the memmap store and the libsvm reader ----------------------------------

_TOY_LIBSVM = (
    "+1 1:0.5 3:-2.0\n"
    "-1 2:1.25\n"
    "+1 1:3.0 4:0.125\n"
    "-1 3:0.75\n"
)


@pytest.mark.parametrize("storage", ["dense", "csr"])
def test_memmap_store_round_trip(tmp_path, planted_inst, sparse_inst, storage):
    """save_store -> from_store: the same matrix and labels, memmap chunks
    re-sliced at another chunk_m, and the chunk-skip path on it equal to
    the in-memory container's bit for bit."""
    if storage == "dense":
        X, y = planted_inst
        fc_mem = FeatureChunked.from_dense(X, chunk_m=32)
    else:
        X, y = sparse_inst.X, sparse_inst.y
        fc_mem = FeatureChunked.from_csr(sparse_inst.csr, chunk_m=32)
    fc_mem.save_store(tmp_path / "s", y=y)
    fc = FeatureChunked.from_store(tmp_path / "s", chunk_m=40)
    first = fc.chunks[0] if storage == "dense" else fc.chunks[0].data
    assert not first.flags.writeable  # a view of the read-only memmap
    np.testing.assert_array_equal(fc.as_dense(), X)
    np.testing.assert_array_equal(fc.labels, y)
    fc = FeatureChunked.from_store(tmp_path / "s")
    kw = dict(rules="feature_vi", tol=1e-9, max_iters=8000, device="cpu")
    grid = dict(n_lambdas=6, lam_min_ratio=0.05)
    res = PathDriver(**kw).run(fc, fc.labels, **grid)
    ref = PathDriver(**kw).run(fc_mem, y, **grid)
    np.testing.assert_array_equal(res.objectives, ref.objectives)
    if storage == "dense":
        assert res.extras["stream_stats"]["chunks_skipped"] > 0
    # the reference reads the port's store
    rfc = ref_sparse.FeatureChunked.from_store(str(tmp_path / "s"))
    np.testing.assert_array_equal(rfc.as_dense(), X)


def test_store_errors(tmp_path, planted_inst):
    """A missing store or file raises StoreMissingError; a truncated file or
    a flipped byte raises StoreCorruptError, the latter before the chunk's
    bytes reach a sweep (no stream, no gather); a persistent read fault
    raises StoreError after its retries, a transient one is retried."""
    X, y = planted_inst
    FeatureChunked.from_dense(X, chunk_m=32).save_store(tmp_path / "s", y=y)
    with pytest.raises(StoreMissingError):
        FeatureChunked.from_store(tmp_path / "nope")
    # a flipped byte in grid chunk 3
    path = tmp_path / "s" / "X.bin"
    raw = bytearray(path.read_bytes())
    raw[3 * 32 * 120 * 4 + 17] ^= 0xFF
    path.write_bytes(bytes(raw))
    fc = FeatureChunked.from_store(tmp_path / "s")
    v = torch.ones(120)
    with pytest.raises(StoreCorruptError, match="chunk 3"):
        fc.matvec(v)
    assert fc.stats["puts"] == 3  # chunks 0-2 streamed, chunk 3 refused
    with pytest.raises(StoreCorruptError, match="chunk 3"):
        fc.gather_rows(np.array([100]))
    np.testing.assert_array_equal(fc.gather_rows(np.array([5, 200])), X[[5, 200]])
    path.write_bytes(bytes(raw[:1000]))
    with pytest.raises(StoreCorruptError, match="truncated"):
        FeatureChunked.from_store(tmp_path / "s")
    os.remove(path)
    with pytest.raises(StoreMissingError, match="X.bin"):
        FeatureChunked.from_store(tmp_path / "s")

    FeatureChunked.from_dense(X, chunk_m=32).save_store(tmp_path / "t", y=y)
    calls = []

    def flaky(tag, attempt):
        calls.append(attempt)
        if attempt == 0:
            raise OSError("transient")

    port_chunked._read_fault_hook = flaky
    try:
        fc = FeatureChunked.from_store(tmp_path / "t")
        fc.verify()
        assert 1 in calls
        fc = FeatureChunked.from_store(tmp_path / "t")

        def down(tag, attempt):
            raise OSError("down")

        port_chunked._read_fault_hook = down
        with pytest.raises(StoreError, match="attempts"):
            fc.verify()
    finally:
        port_chunked._read_fault_hook = None


def test_libsvm_cached_builds_and_rebuilds(tmp_path):
    """The two-pass store build from libsvm text (plain and gzip) gives the
    loader's matrix and the reference's store; a corrupt store is rebuilt
    from the text once; without the text the error propagates."""
    p = tmp_path / "toy.svm"
    p.write_text(_TOY_LIBSVM)
    dense = load_libsvm(p)
    fc, y = FeatureChunked.from_libsvm_cached(p, store_dir=tmp_path / "st", chunk_m=2)
    np.testing.assert_array_equal(fc.as_dense(), dense.X)
    np.testing.assert_array_equal(y, dense.y)
    ref, ry = ref_sparse.FeatureChunked.from_libsvm_cached(
        p, store_dir=tmp_path / "ref_st", chunk_m=2)
    for name in ("data.bin", "indices.bin", "indptr.bin", "y.bin"):
        assert (tmp_path / "st" / name).read_bytes() == \
            (tmp_path / "ref_st" / name).read_bytes()
    fc3, _ = FeatureChunked.from_libsvm_cached(p, store_dir=tmp_path / "st", chunk_m=3)
    np.testing.assert_array_equal(fc3.as_dense(), dense.X)
    pgz = tmp_path / "toy.svm.gz"
    with gzip.open(pgz, "wt") as f:
        f.write(_TOY_LIBSVM)
    fz, yz = FeatureChunked.from_libsvm_cached(pgz, chunk_m=2)
    np.testing.assert_array_equal(fz.as_dense(), dense.X)
    assert (tmp_path / "toy.svm.gz.store" / "meta.json").exists()
    # corrupt the data: rebuilt from the text
    data = tmp_path / "st" / "data.bin"
    raw = bytearray(data.read_bytes())
    raw[0] ^= 0xFF
    data.write_bytes(bytes(raw))
    fc4, _ = FeatureChunked.from_libsvm_cached(p, store_dir=tmp_path / "st", chunk_m=2)
    np.testing.assert_array_equal(fc4.as_dense(), dense.X)
    data.write_bytes(bytes(raw))
    os.remove(p)
    with pytest.raises(StoreCorruptError):
        FeatureChunked.from_libsvm_cached(p, store_dir=tmp_path / "st", chunk_m=2)


@pytest.mark.parametrize("compressed", [False, True], ids=["plain", "gzip"])
def test_load_libsvm_matches_reference(tmp_path, compressed):
    """The copied reader against the reference's: indices, labels, comments,
    dtype and the n_features override; gzip found by its magic bytes."""
    text = ("+1 1:0.5 3:-2.0\n-1 2:1.25\n# comment line\n"
            "0 1:3.0 4:0.125  # trailing comment\n")
    p = tmp_path / "toy.txt"
    if compressed:
        with gzip.open(p, "wt") as f:
            f.write(text)
    else:
        p.write_text(text)
    for kw in ({}, {"n_features": 6}, {"dtype": np.float64}):
        got, ref = load_libsvm(p, **kw), ref_load_libsvm(p, **kw)
        np.testing.assert_array_equal(got.X, ref.X)
        np.testing.assert_array_equal(got.y, ref.y)
        np.testing.assert_array_equal(got.csr.indptr, ref.csr.indptr)
        assert got.X.dtype == ref.X.dtype
    assert list(iter_libsvm(p, zero_based=True))[0] == (1.0, [1, 3], [0.5, -2.0])
    with pytest.raises(ValueError):
        load_libsvm(p, n_features=2)


@pytest.mark.parametrize("line", ["x 1:2\n", "+1 3\n", "+1 a:2\n", "+1 0:2\n"])
def test_load_libsvm_malformed_line(tmp_path, line):
    """A malformed line names the file, the line and the token, in the
    reference's words."""
    p = tmp_path / "bad.svm"
    p.write_text("+1 1:0.5\n" + line)
    with pytest.raises(ValueError) as got:
        load_libsvm(p)
    with pytest.raises(ValueError) as ref:
        ref_load_libsvm(p)
    assert str(got.value) == str(ref.value)
    assert f"{p}:2:" in str(got.value)


# -- the chunked path --------------------------------------------------------

@pytest.fixture(scope="module")
def path_L(dense_inst):
    return float(lipschitz_estimate(_t(dense_inst.X)))


@pytest.mark.parametrize("case", ["feature_vi", "edpp", "dvi", "composite", "dynamic"])
def test_chunked_path_matches_reference_and_in_core(dense_inst, path_L, case):
    """``_run_chunked`` against the reference's chunked path (XLA route)
    and the port's in-core path, with the same L, at 300 fixed iterations
    a step: objectives rel 1e-5. The gathered solves are the in-core
    path's, so with the same keeps the objectives are equal; composite's
    verified sample screen fires, and its kept samples match the
    reference's; dynamic solves with the streamed segmented solver."""
    ds = dense_inst
    rules = "feature_vi" if case == "dynamic" else case
    grid = (dict(n_lambdas=10, lam_min_ratio=0.02) if case == "composite"
            else dict(n_lambdas=6, lam_min_ratio=0.1))
    kw = dict(tol=-1.0, max_iters=300, L=path_L)
    dyn = dict(dynamic=True, screen_every=40) if case == "dynamic" else {}
    fc = FeatureChunked.from_dense(ds.X, chunk_m=97)
    got = PathDriver(rules, device="cpu", **kw, **dyn).run(fc, ds.y, **grid)
    ref = RefDriver(rules, use_pallas=False, **kw, **dyn).run(
        ref_sparse.FeatureChunked.from_dense(ds.X, chunk_m=97), ds.y, **grid)
    core = PathDriver(rules, device="cpu", **kw).run(
        ds.X, ds.y, lambdas=got.lambdas)
    np.testing.assert_allclose(got.lambdas, ref.lambdas, rtol=1e-6)
    np.testing.assert_allclose(got.objectives, ref.objectives, rtol=REL)
    np.testing.assert_allclose(got.objectives, core.objectives, rtol=REL)
    assert got.extras["storage"] == "chunked" and not np.any(got.extras["health"])
    assert got.extras["stream_stats"]["max_put_rows"] <= 97
    if case == "composite":
        assert np.any(got.kept_samples[1:] < 130)
        np.testing.assert_array_equal(got.kept_samples, ref.kept_samples)
    if case == "dynamic":
        assert set(got.extras["dynamic"]) == set(range(1, 6))
    if case == "feature_vi":
        np.testing.assert_array_equal(got.extras["keep_masks"][1:],
                                      core.extras["keep_masks"][1:])


def test_chunked_path_below_lam_max_and_svm_path(dense_inst, path_L):
    """A grid that starts below lambda_max solves step 0 unscreened and
    certifies it; ``svm_path(FeatureChunked)`` runs the same lane."""
    ds = dense_inst
    fc = FeatureChunked.from_dense(ds.X, chunk_m=97)
    lmax = float(lambda_max(_t(ds.X), _t(ds.y)))
    lambdas = lmax * np.array([0.8, 0.6, 0.45])
    got = PathDriver(tol=-1.0, max_iters=300, L=path_L, device="cpu").run(
        fc, ds.y, lambdas=lambdas)
    core = PathDriver(tol=-1.0, max_iters=300, L=path_L, device="cpu").run(
        ds.X, ds.y, lambdas=lambdas)
    assert got.kept[0] == 300 and got.solver_iters[0] == 300
    np.testing.assert_allclose(got.objectives, core.objectives, rtol=REL)
    via = svm_path(FeatureChunked.from_dense(ds.X, chunk_m=97), ds.y,
                   lambdas=lambdas, chunk_skip=False, device="cpu")
    assert via.extras["chunk_skip"] is False and via.extras["storage"] == "chunked"


def test_chunked_path_rejects_unsupported_configs(dense_inst):
    from repro_torch.core.rules.base import (
        AXIS_FEATURES,
        AXIS_SAMPLES,
        ScreeningRule,
    )

    ds = dense_inst
    fc = FeatureChunked.from_dense(ds.X, chunk_m=97)
    with pytest.raises(ValueError, match="gather"):
        PathDriver(rules="feature_vi", reduce="mask", device="cpu").run(fc, ds.y)

    class _NoProgram(ScreeningRule):
        axis = AXIS_FEATURES

        def bounds(self, X, y, region):  # pragma: no cover - never reached
            raise NotImplementedError

    with pytest.raises(ValueError, match="feature rule"):
        PathDriver(rules=[_NoProgram()], device="cpu").run(fc, ds.y)

    class _OddSample(ScreeningRule):
        axis = AXIS_SAMPLES

        def bounds(self, X, y, region):  # pragma: no cover - never reached
            raise NotImplementedError

    with pytest.raises(ValueError, match="SampleVIRule"):
        PathDriver(rules=[_OddSample()], device="cpu").run(fc, ds.y)
    for engine in ("scan", "batched"):
        with pytest.raises(ValueError, match="host"):
            svm_path(fc, ds.y, engine=engine, device="cpu")


def test_sample_stats_and_slices(dense_inst):
    """The sample-axis sweep's margins and column norms, and the anchor and
    fixed-stat slices the chunk cache reads."""
    ds = dense_inst
    X, y = _t(ds.X), _t(ds.y)
    w = _t(np.random.default_rng(2).standard_normal(300).astype(np.float32))
    u1, x_sq = stream_sample_stats(FeatureChunked.from_dense(ds.X, chunk_m=97), y, w, 0.25)
    _close(u1, X.t() @ w + 0.25)
    _close(x_sq, (X * X).sum(0))
    y_, lmax, theta = _anchor(ds)
    red = stream_feature_reductions(FeatureChunked.from_dense(ds.X, chunk_m=97), y, theta)
    a = anchor_stats(y, lmax, theta, 0.0, red.d_theta)
    fixed = fixed_stats(y, red.d_one, red.d_y, red.d_sq)
    full = finalize_from_anchor(a, 0.7 * lmax, fixed)
    part = finalize_from_anchor(anchor_slice(a, 97, 194), 0.7 * lmax,
                                fixed_slice(fixed, 97, 194))
    assert torch.equal(part, full[97:194])
    rf = ref_fixed_stats(jnp.asarray(ds.y), *ref_sparse.fixed_reductions(
        ref_sparse.FeatureChunked.from_dense(ds.X, chunk_m=97), ds.y))
    _close(fixed.d_sq, rf.d_sq)


@pytest.mark.parametrize("storage", ["chunked", "csr", "mmap"])
def test_launcher_storage(tmp_path, capsys, storage, monkeypatch):
    """``--storage chunked|csr|mmap`` on the CPU: step lines with the live
    chunks, and a last line with the transfer counts."""
    monkeypatch.chdir(tmp_path)  # the launcher writes artifacts/ here
    args = ["--m", "200", "--n", "80", "--n-lambdas", "4", "--chunk-m", "64",
            "--device", "cpu", "--storage", storage]
    if storage == "csr":
        args += ["--density", "0.05"]
    if storage == "mmap":
        ds = make_sparse_classification(m=60, n=30, seed=1, density=0.3)
        p = tmp_path / "d.svm"
        with open(p, "w") as f:
            for i in range(30):
                col = ds.X[:, i]
                nz = np.nonzero(col)[0]
                f.write(f"{int(ds.y[i])} " + " ".join(
                    f"{j + 1}:{float(col[j])!r}" for j in nz) + "\n")
        args += ["--libsvm", str(p), "--store-dir", str(tmp_path / "st"),
                 "--no-chunk-skip"]
    assert launcher(args) == 0
    out = capsys.readouterr().out
    assert f"storage={storage}" in out and "live_chunks=" in out
    assert "max_put_rows=" in out and "csr_puts=" in out
    if storage == "mmap":
        assert (tmp_path / "st" / "meta.json").exists() and "chunk_skip=False" in out
