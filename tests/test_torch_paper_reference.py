"""The port's copy of the paper's literal closed forms
(``repro_torch.core.paper_reference``: Algorithm 1, Theorems 6.5/6.7/6.9,
feature at a time in numpy) against the port's geometric screen
(``core.screening.screen_bounds`` on the CPU) on random instances, at the
tolerances of the reference's own cross-check (``tests/test_paper_reference.py``):
rtol = atol = 2e-4 at lambda_max, 5e-4 from a solved anchor. The copy gives
the reference module's bounds bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.core import paper_reference as ref_paper
from repro_torch.core import paper_reference
from repro_torch.core.dual import lambda_max, safe_theta_and_delta, theta_at_lambda_max
from repro_torch.core.screening import screen_bounds
from repro_torch.core.solver import fista_solve
from repro_torch.data import make_sparse_classification

CASES = [(int(s), float(r)) for s, r in zip(
    np.random.default_rng(2014).integers(0, 10_000, 10),
    np.random.default_rng(2015).uniform(0.1, 0.95, 10))]


def _instance(m, n, seed):
    ds = make_sparse_classification(m=m, n=n, seed=seed)
    return torch.from_numpy(ds.X), torch.from_numpy(ds.y)


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.float64)


@pytest.mark.parametrize("seed,ratio", CASES)
def test_paper_formulas_match_geometric(seed, ratio):
    X, y = _instance(50, 36, seed)
    lmax = float(lambda_max(X, y))
    theta1 = theta_at_lambda_max(y, lmax)
    ours = screen_bounds(X, y, lmax, ratio * lmax, theta1).numpy().astype(np.float64)
    paper = paper_reference.screen_bounds_paper(_f64(X), _f64(y), lmax, ratio * lmax,
                                                _f64(theta1))
    np.testing.assert_allclose(ours, paper, rtol=2e-4, atol=2e-4)


def test_paper_formulas_match_with_solved_theta():
    """Agreement also holds off the lambda_max special case."""
    X, y = _instance(60, 40, 77)
    lam1 = 0.6 * float(lambda_max(X, y))
    res = fista_solve(X, y, lam1, max_iters=40000, tol=1e-13)
    theta1, _ = safe_theta_and_delta(X, y, res.w, res.b, lam1)
    ours = screen_bounds(X, y, lam1, 0.5 * lam1, theta1).numpy().astype(np.float64)
    paper = paper_reference.screen_bounds_paper(_f64(X), _f64(y), lam1, 0.5 * lam1,
                                                _f64(theta1))
    np.testing.assert_allclose(ours, paper, rtol=5e-4, atol=5e-4)


def test_copy_gives_the_reference_modules_bounds():
    X, y = _instance(40, 30, 5)
    lmax = float(lambda_max(X, y))
    args = (_f64(X), _f64(y), lmax, 0.4 * lmax, _f64(theta_at_lambda_max(y, lmax)))
    np.testing.assert_array_equal(paper_reference.screen_bounds_paper(*args),
                                  ref_paper.screen_bounds_paper(*args))
