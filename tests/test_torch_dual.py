"""``repro_torch.core.dual`` against ``repro.core.dual`` on the same arrays.

Tolerance: rtol 1e-5, the fp32 scale (both packages sum in fp32, in
different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dual as rd
import repro_torch.core.dual as td
from repro_torch.convert import state_from_numpy
from repro_torch.data import make_sparse_classification

RTOL = 1e-5


@pytest.fixture(scope="module", params=[(150, 100, 7), (300, 77, 2)])
def case(request):
    m, n, seed = request.param
    ds = make_sparse_classification(m=m, n=n, seed=seed)
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(m) * (rng.random(m) < 0.1)).astype(np.float32)
    b = np.float32(rng.uniform(-0.3, 0.3))
    st = state_from_numpy({"X": ds.X, "y": ds.y, "w": w, "b": b}, "cpu")
    return ds, w, b, st


def _close(port, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(port, np.float64), ref, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(ref).max())))


def test_lambda_max_and_theta(case):
    ds, _, _, st = case
    lm_r = rd.lambda_max(jnp.asarray(ds.X), jnp.asarray(ds.y))
    lm_p = td.lambda_max(st["X"], st["y"])
    _close(float(lm_p), float(lm_r))
    _close(td.theta_at_lambda_max(st["y"], lm_p),
           rd.theta_at_lambda_max(jnp.asarray(ds.y), lm_r))
    _close(float(td.bias_at_lambda_max(st["y"])),
           float(rd.bias_at_lambda_max(jnp.asarray(ds.y))))
    assert int(td.first_features(st["X"], st["y"])) == int(
        rd.first_features(jnp.asarray(ds.X), jnp.asarray(ds.y)))


def test_primal_quantities(case):
    ds, w, b, st = case
    X, y = jnp.asarray(ds.X), jnp.asarray(ds.y)
    lam = 0.3 * float(rd.lambda_max(X, y))
    _close(td.xi_from_primal(st["X"], st["y"], st["w"], st["b"]),
           rd.xi_from_primal(X, y, jnp.asarray(w), jnp.asarray(b)))
    _close(td.theta_from_primal(st["X"], st["y"], st["w"], st["b"], lam),
           rd.theta_from_primal(X, y, jnp.asarray(w), jnp.asarray(b), lam))
    _close(float(td.primal_objective(st["X"], st["y"], st["w"], st["b"], lam)),
           float(rd.primal_objective(X, y, jnp.asarray(w), jnp.asarray(b), lam)))
    alpha = np.abs(np.random.default_rng(1).standard_normal(ds.y.shape[0])).astype(np.float32)
    _close(float(td.dual_objective(torch.from_numpy(alpha))),
           float(rd.dual_objective(jnp.asarray(alpha))))


def test_safe_theta_and_delta(case):
    ds, w, b, st = case
    X, y = jnp.asarray(ds.X), jnp.asarray(ds.y)
    lam = 0.3 * float(rd.lambda_max(X, y))
    th_r, d_r = rd.safe_theta_and_delta(X, y, jnp.asarray(w), jnp.asarray(b),
                                        jnp.asarray(lam))
    th_p, d_p = td.safe_theta_and_delta(st["X"], st["y"], st["w"], st["b"], lam)
    _close(th_p, th_r)
    _close(float(d_p), float(d_r))
    est_r = rd.duality_gap_estimate(X, y, jnp.asarray(w), jnp.asarray(b), lam)
    est_p = td.duality_gap_estimate(st["X"], st["y"], st["w"], st["b"], lam)
    _close(float(est_p.primal), float(est_r.primal))
    _close(float(est_p.dual), float(est_r.dual))
