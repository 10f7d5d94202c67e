"""``repro_torch.core.screening`` against ``repro.core.screening``.

Same anchors fed to both packages (numpy -> ``convert.state_from_numpy``).
Tolerances: bounds rtol 1e-4 (fp32 reductions summed in different orders,
then the closed form's cancellations); keep masks must be equal except for
features whose reference bound lies within 1e-4 relative of tau, where the
fp32 noise of either package may land on either side.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.screening as rs
from repro.core.dual import lambda_max as ref_lambda_max
from repro.core.dual import safe_theta_and_delta as ref_certify
from repro.core.dual import theta_at_lambda_max as ref_theta_max
from repro.core.paper_reference import screen_bounds_paper
from repro.core.solver import fista_solve as ref_fista
from repro_torch.convert import state_from_numpy
from repro_torch.core import screening as ts
from repro_torch.data import make_sparse_classification

RTOL = 1e-4
TAU_BAND = 1e-4


def _unbalance(y, frac_pos, seed):
    """Relabel so that ``frac_pos`` of the samples are +1."""
    rng = np.random.default_rng(seed)
    y = -np.ones_like(y)
    y[rng.permutation(len(y))[: int(frac_pos * len(y))]] = 1.0
    return y


def _anchor(kind, seed):
    """(X, y, lam1, lam2, theta1, delta) as numpy: 'lam_max' is the exact
    anchor at lambda_max (delta 0); 'solved' a certified anchor from an
    approximate solve; 'random' an arbitrary positive theta1."""
    ds = make_sparse_classification(m=240, n=90, seed=seed)
    X, y = ds.X, ds.y
    if kind == "lam_max_unbalanced":
        y = _unbalance(y, 0.7, seed).astype(np.float32)
    lmax = float(ref_lambda_max(jnp.asarray(X), jnp.asarray(y)))
    rng = np.random.default_rng(seed + 100)
    if kind.startswith("lam_max"):
        lam1, delta = lmax, 0.0
        theta1 = np.asarray(ref_theta_max(jnp.asarray(y), jnp.asarray(lmax)))
    elif kind == "solved":
        lam1 = 0.6 * lmax
        res = ref_fista(jnp.asarray(X), jnp.asarray(y), lam1, max_iters=300)
        th, d = ref_certify(jnp.asarray(X), jnp.asarray(y), res.w, res.b,
                            jnp.asarray(lam1))
        theta1, delta = np.asarray(th), float(d)
    else:
        lam1 = rng.uniform(0.3, 0.9) * lmax
        theta1 = (np.abs(rng.standard_normal(len(y))) / lam1).astype(np.float32)
        delta = float(rng.uniform(0.0, 0.05))
    lam2 = rng.uniform(0.4, 0.95) * lam1
    return X, y, lam1, lam2, theta1.astype(np.float32), delta


KINDS = ["lam_max", "lam_max_unbalanced", "solved", "random"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_screen_matches_reference(kind, seed):
    X, y, lam1, lam2, theta1, delta = _anchor(kind, seed)
    st = state_from_numpy({"X": X, "y": y, "theta": theta1}, "cpu")
    for d in sorted({0.0, delta}):
        keep_r, b_r = rs.screen(jnp.asarray(X), jnp.asarray(y), lam1, lam2,
                                jnp.asarray(theta1), delta=d)
        keep_p, b_p = ts.screen(st["X"], st["y"], lam1, lam2, st["theta"],
                                delta=d)
        b_r = np.asarray(b_r, np.float64)
        np.testing.assert_allclose(b_p.numpy(), b_r, rtol=RTOL,
                                   atol=RTOL * max(1.0, np.abs(b_r).max()))
        near_tau = np.abs(b_r - rs.SAFE_TAU) <= TAU_BAND * rs.SAFE_TAU
        differ = keep_p.numpy() != np.asarray(keep_r)
        assert not np.any(differ & ~near_tau)


def test_unbalanced_lam_max_halfspace_is_vacuous():
    """At lam_max with unbalanced classes a is parallel to y: ||Qa||^2 is
    rounding noise and ``_t_max`` must ignore the halfspace (ball case)."""
    X, y, lam1, lam2, theta1, _ = _anchor("lam_max_unbalanced", 3)
    st = state_from_numpy({"X": X, "y": y, "theta": theta1}, "cpu")
    sh = ts.shared_scalars(st["y"], lam1, lam2, st["theta"])
    assert float(sh.qa_sq) <= 1e-9 and bool(sh.halfspace_valid)
    sh_r = rs.shared_scalars(jnp.asarray(y), lam1, lam2, jnp.asarray(theta1))
    for name in ("inv_lam1", "inv_lam2", "yc", "ysq", "r_h_sq", "g0", "a_norm",
                 "a_dot_y", "a_dot_one", "theta_dot_one"):
        np.testing.assert_allclose(float(getattr(sh, name)),
                                   float(getattr(sh_r, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["lam_max", "lam_max_unbalanced"])
def test_bounds_match_paper_algorithm(kind):
    """The paper's Algorithm 1, literally (numpy, fp64), gives the same
    bounds; tolerance 2e-4 as the reference's own cross-check."""
    X, y, lam1, lam2, theta1, _ = _anchor(kind, 4)
    st = state_from_numpy({"X": X, "y": y, "theta": theta1}, "cpu")
    ours = ts.screen_bounds(st["X"], st["y"], lam1, lam2, st["theta"]).numpy()
    paper = screen_bounds_paper(X.astype(np.float64), y.astype(np.float64),
                                lam1, lam2, theta1.astype(np.float64))
    np.testing.assert_allclose(ours, paper, rtol=2e-4, atol=2e-4)


def test_nan_anchor_keeps_every_feature():
    X, y, lam1, lam2, theta1, _ = _anchor("random", 5)
    theta1 = theta1.copy()
    theta1[3] = np.nan
    st = state_from_numpy({"X": X, "y": y, "theta": theta1}, "cpu")
    keep, bounds = ts.screen(st["X"], st["y"], lam1, lam2, st["theta"])
    assert bool(keep.all()) and bool(bounds.isnan().all())
