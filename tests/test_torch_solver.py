"""``repro_torch.core.solver`` against ``repro.core.solver``.

Both solvers get the same L, warm start and sample mask. Objectives must
agree to rel 1e-5: the reference's own host-vs-scan spread is 7.9e-6
(BENCH_screening.json engines.max_rel_obj_diff). Iteration counts are not
compared (they hinge on fp32 plateau ties in either package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dual import lambda_max as ref_lambda_max
from repro.core.solver import fista_solve as ref_fista
from repro_torch.convert import state_from_numpy
from repro_torch.core.solver import fista_solve, lipschitz_estimate, soft_threshold
from repro_torch.data import make_sparse_classification

REL = 1e-5


def _problem(m, n, seed):
    ds = make_sparse_classification(m=m, n=n, seed=seed)
    lmax = float(ref_lambda_max(jnp.asarray(ds.X), jnp.asarray(ds.y)))
    A = np.vstack([ds.X.astype(np.float64), np.ones((1, n))])
    L = np.float32(np.linalg.norm(A, 2) ** 2)
    return ds, lmax, L


@pytest.mark.parametrize("ratio", [0.7, 0.3, 0.1])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fista_matches_reference(ratio, warm, masked):
    ds, lmax, L = _problem(200, 120, seed=2)
    rng = np.random.default_rng(4)
    lam = ratio * lmax
    w0 = (rng.standard_normal(200) * 0.05 * (rng.random(200) < 0.2)).astype(np.float32)
    b0 = np.float32(0.1)
    sm = (rng.random(120) < 0.8).astype(np.float32)
    kw_r = dict(L=jnp.asarray(L), max_iters=3000, tol=1e-9)
    kw_p = dict(L=float(L), max_iters=3000, tol=1e-9)
    if warm:
        kw_r.update(w0=jnp.asarray(w0), b0=jnp.asarray(b0))
        kw_p.update(w0=torch.from_numpy(w0), b0=torch.tensor(b0))
    if masked:
        kw_r.update(sample_mask=jnp.asarray(sm))
        kw_p.update(sample_mask=torch.from_numpy(sm))
    st = state_from_numpy({"X": ds.X, "y": ds.y}, "cpu")
    r = ref_fista(jnp.asarray(ds.X), jnp.asarray(ds.y), lam, **kw_r)
    p = fista_solve(st["X"], st["y"], lam, **kw_p)
    np.testing.assert_allclose(p.obj, float(r.obj), rtol=REL)
    assert p.health == 0 and p.converged
    # the carried margins are the accepted point's
    np.testing.assert_allclose(p.u.numpy(), (st["X"].t() @ p.w).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_valid_m_on_padded_buffer_matches_unpadded():
    """A zero-padded gather buffer with valid_m = kept solves the same
    problem as the kept rows alone."""
    ds, lmax, L = _problem(64, 80, seed=6)
    st = state_from_numpy({"X": ds.X, "y": ds.y}, "cpu")
    kept = 37
    Xr = torch.zeros((64, 80))
    Xr[:kept] = st["X"][:kept]
    a = fista_solve(st["X"][:kept].contiguous(), st["y"], 0.3 * lmax, L=float(L))
    b = fista_solve(Xr, st["y"], 0.3 * lmax, L=float(L), valid_m=kept)
    np.testing.assert_allclose(b.obj, a.obj, rtol=REL)
    assert bool((b.w[kept:] == 0).all())


def test_nan_warm_start_trips_guard_and_recovers():
    ds, lmax, L = _problem(150, 90, seed=3)
    st = state_from_numpy({"X": ds.X, "y": ds.y}, "cpu")
    w0 = torch.zeros(150)
    w0[5] = float("nan")
    res = fista_solve(st["X"], st["y"], 0.4 * lmax, w0=w0, L=float(L))
    clean = fista_solve(st["X"], st["y"], 0.4 * lmax, L=float(L))
    assert res.health >= 1
    assert np.isfinite(res.obj) and bool(torch.isfinite(res.w).all())
    np.testing.assert_allclose(res.obj, clean.obj, rtol=REL)


def test_invalid_step_size_trips_guard_and_stays_finite():
    """An L far below the true constant makes the prox step non-monotone:
    the guard rolls back, halves the step, and the result stays finite."""
    ds, lmax, L = _problem(150, 90, seed=8)
    st = state_from_numpy({"X": ds.X, "y": ds.y}, "cpu")
    res = fista_solve(st["X"], st["y"], 0.3 * lmax, L=float(L) * 1e-3,
                      max_iters=500)
    assert res.health >= 1
    assert np.isfinite(res.obj) and bool(torch.isfinite(res.w).all())


@pytest.mark.parametrize("shape", [(2000, 400), (300, 200), (100, 150)])
@pytest.mark.parametrize("seed", [0, 11])
def test_lipschitz_estimate_bounds_spectrum(shape, seed):
    """Never above sigma_max([X; 1^T])^2 beyond rounding, and within 1%."""
    m, n = shape
    ds = make_sparse_classification(m=m, n=n, seed=seed)
    A = np.vstack([ds.X.astype(np.float64), np.ones((1, n))])
    exact = np.linalg.norm(A, 2) ** 2
    est = float(lipschitz_estimate(torch.from_numpy(ds.X)))
    assert est <= exact * (1 + 1e-5)
    assert est >= 0.99 * exact


def test_soft_threshold():
    x = torch.tensor([-3.0, -0.5, 0.0, 0.2, 2.0])
    np.testing.assert_array_equal(soft_threshold(x, 1.0).numpy(),
                                  [-2.0, 0.0, 0.0, 0.0, 1.0])
