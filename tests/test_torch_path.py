"""The port's screened path against the reference's host ``svm_path``.

Bench instance: m=2000, n=400, 10 lambdas, lam_min_ratio 0.05, seed 11.
Both packages get the same L (``PathDriver(L=)``). Per-step objectives must
agree to rel 1e-5 (the reference's own host-vs-scan spread is 7.9e-6).

Kept counts are not compared step by step between the two paths: each
step's anchor radius delta comes from a duality gap at an approximate
solution, and it moves by tens of percent with differences in w at the
1e-5 level (fp32 sums in another order). Instead the port's rule is held
to the reference's on the reference's own anchors, with the tau-margin
rule of test_torch_screening.py. Safety is checked exactly against the
port's unscreened path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.path as tpath
from repro.core.dual import safe_theta_and_delta as ref_certify
from repro.core.dual import theta_at_lambda_max as ref_theta_max
from repro.core.path import PathDriver as RefDriver
from repro.core.rules import FeatureVIRule as RefRule
from repro.core.rules import ConvexRegion as RefRegion
from repro.core.screening import SAFE_TAU
from repro_torch.convert import path_arrays, state_from_numpy
from repro_torch.core.path import PathDriver, svm_path
from repro_torch.core.rules import ConvexRegion, FeatureVIRule
from repro_torch.core.solver import HEALTH_SCREEN_REFUSED, lipschitz_estimate
from repro_torch.data import make_sparse_classification

REL = 1e-5
GRID = dict(n_lambdas=10, lam_min_ratio=0.05)


@pytest.fixture(scope="module")
def bench():
    ds = make_sparse_classification(m=2000, n=400, seed=11)
    L = float(lipschitz_estimate(torch.from_numpy(ds.X)))
    ref = RefDriver("feature_vi", L=L).run(ds.X, ds.y, **GRID)
    port = PathDriver("feature_vi", L=L, device="cpu").run(ds.X, ds.y, **GRID)
    unscreened = PathDriver([], L=L, device="cpu").run(ds.X, ds.y, **GRID)
    return ds, L, ref, port, unscreened


def test_objectives_match_reference(bench):
    _, _, ref, port, unscreened = bench
    r, p = path_arrays(ref), path_arrays(port)
    # the grids start at each package's fp32 lambda_max
    np.testing.assert_allclose(p["lambdas"], r["lambdas"], rtol=1e-6)
    np.testing.assert_allclose(p["objectives"], r["objectives"], rtol=REL)
    np.testing.assert_allclose(path_arrays(unscreened)["objectives"],
                               r["objectives"], rtol=REL)
    assert port.extras["lam_max"] == pytest.approx(ref.extras["lam_max"], rel=REL)
    assert not np.any(port.extras["health"])
    assert port.kept[1] < 2000  # screening discards near lam_max


def test_screen_matches_reference_on_reference_anchors(bench):
    """At every step, the reference's anchor from its previous accepted
    solution fed to both rules: keep masks equal except within 1e-4 of tau."""
    ds, _, ref, _, _ = bench
    X, y = jnp.asarray(ds.X), jnp.asarray(ds.y)
    st = state_from_numpy({"X": ds.X, "y": ds.y}, "cpu")
    lams = ref.lambdas
    for k in range(1, len(lams)):
        if k == 1:
            theta = ref_theta_max(y, jnp.asarray(lams[0]))
            delta = 0.0
        else:
            theta, delta = ref_certify(
                X, y, jnp.asarray(ref.weights[k - 1], jnp.float32),
                jnp.asarray(ref.biases[k - 1], jnp.float32),
                jnp.asarray(lams[k - 1]))
        b_r = np.asarray(RefRule().bounds(
            X, y, RefRegion.build(y, lams[k - 1], lams[k], theta, delta=delta)),
            np.float64)
        a = state_from_numpy({"theta": np.asarray(theta),
                              "delta": np.float32(delta)}, "cpu")
        region = ConvexRegion.build(st["y"], lams[k - 1], lams[k], a["theta"],
                                    delta=a["delta"])
        keep_p, b_p = FeatureVIRule().screen(st["X"], st["y"], region)
        np.testing.assert_allclose(b_p.numpy(), b_r, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(b_r).max()))
        differ = keep_p.numpy() != (b_r >= SAFE_TAU)
        assert not np.any(differ & (np.abs(b_r - SAFE_TAU) > 1e-4 * SAFE_TAU)), k
        if k == 1:  # the exact anchor: the reference path kept exactly these
            assert int(keep_p.sum()) == ref.kept[1]


def test_screening_is_safe(bench):
    """Every feature nonzero in the unscreened solve is kept at its step."""
    _, _, _, port, unscreened = bench
    masks = port.extras["keep_masks"]
    for k in range(1, len(port.lambdas)):
        w = np.abs(unscreened.weights[k])
        support = w > 1e-6 * w.max() if w.max() > 0 else np.zeros_like(w, bool)
        assert np.all(masks[k][support]), k
        assert masks[k].sum() == port.kept[k]
        assert np.all(port.weights[k][~masks[k]] == 0)


def test_step0_below_lam_max_matches_reference(bench):
    ds, L, ref, _, _ = bench
    lams = ref.extras["lam_max"] * np.geomspace(0.9, 0.3, 4)
    r = RefDriver("feature_vi", L=L).run(ds.X, ds.y, lambdas=lams)
    p = PathDriver("feature_vi", L=L, device="cpu").run(ds.X, ds.y, lambdas=lams)
    assert p.kept[0] == 2000 and p.solver_iters[0] > 0
    np.testing.assert_allclose(p.objectives, r.objectives, rtol=REL)
    # the user entry point, with its own Lipschitz estimate
    e = svm_path(ds.X, ds.y, lambdas=lams, device="cpu")
    np.testing.assert_allclose(e.objectives, r.objectives, rtol=REL)


def test_refused_certificate_keeps_every_feature(bench, monkeypatch):
    """A non-finite certificate after step 2 refuses step 3's screen: every
    feature is kept, the refusal is flagged, and the path is unchanged."""
    ds, L, _, port, _ = bench
    real = tpath.safe_theta_and_delta
    calls = []

    def poisoned(X, y, w, b, lam):
        theta, delta = real(X, y, w, b, lam)
        calls.append(lam)
        if len(calls) == 2:
            delta = delta * float("nan")
        return theta, delta

    monkeypatch.setattr(tpath, "safe_theta_and_delta", poisoned)
    res = PathDriver("feature_vi", L=L, device="cpu").run(ds.X, ds.y, **GRID)
    assert res.extras["health"][3] & HEALTH_SCREEN_REFUSED
    assert res.kept[3] == 2000 and res.extras["keep_masks"][3].all()
    assert not any(h & HEALTH_SCREEN_REFUSED for i, h in
                   enumerate(res.extras["health"]) if i != 3)
    np.testing.assert_allclose(res.objectives, port.objectives, rtol=REL)


@pytest.mark.parametrize("reduce", ["gather", "mask"])
def test_kept_samples_match_reference(reduce):
    """A grid that starts below lambda_max solves step 0 unscreened: both
    packages report kept[0] = m and the reference's kept_samples[0] = 0."""
    ds = make_sparse_classification(m=300, n=120, seed=21)
    L = float(lipschitz_estimate(torch.from_numpy(ds.X)))
    lmax = RefDriver("composite", L=L, reduce=reduce).run(
        ds.X, ds.y, n_lambdas=2).extras["lam_max"]
    lams = lmax * np.geomspace(0.8, 0.1, 4)
    r = RefDriver("composite", L=L, reduce=reduce).run(ds.X, ds.y, lambdas=lams)
    p = PathDriver("composite", L=L, reduce=reduce, device="cpu").run(
        ds.X, ds.y, lambdas=lams)
    assert p.solver_iters[0] > 0
    assert p.kept[0] == r.kept[0] == 300
    assert p.kept_samples[0] == r.kept_samples[0]
    np.testing.assert_allclose(p.objectives, r.objectives, rtol=REL)


@pytest.mark.parametrize("reduce", ["gather", "mask"])
@pytest.mark.parametrize("rules", ["feature_vi", "composite"])
def test_exact_lipschitz_matches_reference(rules, reduce):
    """``exact_lipschitz=True``: every solve estimates L on its own reduced or
    masked X, in each package by its own power iteration (30 steps in the
    reference, 100 here), so the iterates differ at fixed iterations; at the
    default stop rule the objectives agree to rel 1e-5. Step 1 screens from
    the closed-form anchor at lambda_max, the same in both, so its kept
    count is the reference's (later ones follow each package's gap)."""
    ds = make_sparse_classification(m=300, n=120, k_active=10, seed=41)
    grid = dict(n_lambdas=8, lam_min_ratio=0.02)
    r = RefDriver(rules, reduce=reduce, exact_lipschitz=True).run(ds.X, ds.y, **grid)
    p = PathDriver(rules, reduce=reduce, exact_lipschitz=True, device="cpu").run(
        ds.X, ds.y, **grid)
    np.testing.assert_allclose(p.objectives, np.asarray(r.objectives), rtol=REL)
    assert p.kept[1] == int(r.kept[1]) < 300
    assert not np.any(p.extras["health"])
    if rules == "composite":
        assert p.kept_samples.min() < 120  # the sample rule screens on this grid
