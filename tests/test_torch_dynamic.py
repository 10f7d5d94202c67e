"""Dynamic (in-solver) screening and the DVI rule in the port, against the
reference (the port's versions of ``tests/test_dynamic.py``'s D1-D4, DS and
V1).

Instance: the reference's own, ``make_sparse_classification(m=400, n=160,
k_active=12, seed=77)``; both packages get the same arrays and the same L.
Tolerances, and why:

* ``gap_theta_delta``: theta, delta and gap to rel 1e-5 (fp32 sums in two
  orders), at an iterate 5 FISTA steps from zero. The gap is a difference
  of two O(objective) sums, so near the optimum its relative error grows as
  objective / gap (rel 4.5e-4 between the packages after 100 steps here):
  the certificate is compared where the gap is of the objective's order.
* refresh bounds and the dynamic kernel's plain version against the
  reference's jnp expression (``solver._dynamic_run``): rel 1e-5 with an
  absolute floor of 1e-5 of the bounds' scale, as the other kernels. The
  CUDA variant against this plain version is a card-only case of
  ``tests/test_torch_kernels.py``, which collects without JAX.
* ``fista_solve_dynamic`` against the reference's: objective rel 1e-6,
  ``w`` atol 1e-4 (the reference's own dynamic-vs-static check).
* ``PathDriver(dynamic=True)`` against the port's sequential path:
  objectives rel 1e-6, weights atol 3e-3. Against the reference's dynamic
  path the same tolerances hold at a fixed 300 iterations a step
  (``tol=-1``), where the stop rule is out of play. At the default stop
  rule (three exact fp32 ties) a solve can stall ~1e-5 above its optimum
  wherever rounding differs: the reference's gather path stops 5.9e-6 above
  the port's (and the optimum) at step 4 here, so that comparison is held
  at rel 1e-5, the port's other path-vs-reference tolerance.
* DVI bounds on the reference's anchors: rtol 1e-4, keep masks equal away
  from tau, as ``test_torch_screening.py`` holds the VI bound.

Iteration and segment counts are never compared: the masks restart
momentum, and the stop rule ties on fp32 plateaus.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DVIRule as RefDVIRule
from repro.core import FeatureVIRule as RefFeatureRule
from repro.core import PathDriver as RefDriver
from repro.core import fista_solve as ref_fista
from repro.core import fista_solve_dynamic as ref_dynamic
from repro.core.dual import safe_theta_and_delta as ref_certify
from repro.core.dual import theta_at_lambda_max as ref_theta_max
from repro.core.rules import ConvexRegion as RefRegion
from repro.core.screening import FeatureReductions as RefReductions
from repro.core.screening import screen_bounds_from_reductions as ref_from_reductions
from repro.core.screening import shared_scalars_from_stats as ref_stats
from repro.core.solver import gap_theta_delta as ref_gap
import repro_torch.core.solver as tsolver
from repro_torch.core.dual import lambda_max
from repro_torch.core.path import PathDriver
from repro_torch.core.rules import (
    ConvexRegion,
    DVIRule,
    FeatureVIRule,
    available_rules,
    dynamic_tau,
    get_rule,
)
from repro_torch.core.screening import SAFE_TAU, shared_scalars_from_stats
from repro_torch.core.solver import (
    HEALTH_SCREEN_REFUSED,
    fista_solve,
    fista_solve_dynamic,
    gap_theta_delta,
    lipschitz_estimate,
    refresh_bounds,
)
from repro_torch.data import make_sparse_classification
from repro_torch.kernels import screen
from repro_torch.launch.train_svm import main as train_main

SHAPES = [(64, 64), (128, 256), (300, 200), (513, 130)]
DTYPES = [torch.float32, torch.bfloat16]
GRID = dict(n_lambdas=6, lam_min_ratio=0.05)
PATH_KW = dict(tol=1e-10, max_iters=20000)
REDUCE = ["gather", "mask"]


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
def inst():
    ds = make_sparse_classification(m=400, n=160, k_active=12, seed=77)
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    L = float(lipschitz_estimate(X))
    return ds, X, y, L, float(lambda_max(X, y))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(port, reference, rel=1e-5):
    reference = np.asarray(reference, np.float64)
    np.testing.assert_allclose(
        np.asarray(port, np.float64), reference, rtol=rel,
        atol=rel * max(1.0, float(np.abs(reference[np.isfinite(reference)]).max(
            initial=0.0))))


def _sample_mask(n, seed=0):
    return (np.random.default_rng(seed).random(n) < 0.7).astype(np.float32)


def _ref_refresh(X, y, lam, theta, delta, smv):
    """The reference's in-solver bound (``solver._dynamic_run``: the
    ``bound_statics`` over the live samples and the gap-sphere cap), as its
    jnp expression."""
    X, y, theta, smv = _j(X), _j(y), _j(theta), _j(smv)
    lam, delta = jnp.asarray(lam, jnp.float32), jnp.asarray(delta, jnp.float32)
    d_one, d_y, d_sq = X @ (y * smv), X @ smv, (X * X) @ smv
    sh = ref_stats(lam, lam, one_y=jnp.sum(y * smv), theta_dot_one=jnp.sum(theta),
                   theta_dot_y=theta @ y, theta_sq=theta @ theta,
                   n_tot=jnp.sum(smv), delta=delta)
    red = RefReductions(d_theta=X @ (y * theta), d_one=d_one, d_y=d_y, d_sq=d_sq)
    return np.asarray(jnp.minimum(
        ref_from_reductions(red, sh),
        jnp.abs(red.d_theta) + jnp.sqrt(jnp.maximum(d_sq, 0.0)) * delta))


# -- gap_theta_delta -------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["all", "sample_mask"])
@pytest.mark.parametrize("with_u", [False, True], ids=["sweep", "u_given"])
def test_gap_theta_delta_matches_reference(inst, masked, with_u):
    ds, X, y, L, lmax = inst
    lam = 0.25 * lmax
    it = fista_solve(X, y, lam, max_iters=5, L=L)
    sm = _sample_mask(X.shape[1]) if masked else None
    sm_t = None if sm is None else torch.from_numpy(sm)
    u = torch.mv(X.t(), it.w) if with_u else None
    theta, delta, gap = gap_theta_delta(X, y, it.w, it.b, lam, sm_t, u=u)
    r_theta, r_delta, r_gap = ref_gap(
        _j(ds.X), _j(ds.y), _j(it.w), jnp.asarray(float(it.b)),
        jnp.asarray(lam, jnp.float32), None if sm is None else _j(sm),
        u=None if u is None else _j(u))
    _close(theta, r_theta)
    assert float(delta) == pytest.approx(float(r_delta), rel=1e-5)
    assert float(gap) == pytest.approx(float(r_gap), rel=1e-5)
    assert float(gap) > 0.1 * float(it.obj)  # the gap is of the objective's order
    if masked:  # theta is pinned to zero off the live samples
        assert float(theta[sm == 0].abs().max()) == 0.0


def test_gap_theta_delta_poisoned_iterate_gives_inf(inst):
    ds, X, y, _, lmax = inst
    w = torch.zeros(X.shape[0])
    w[3] = float("nan")
    theta, delta, gap = gap_theta_delta(X, y, w, torch.tensor(0.1), 0.3 * lmax)
    _, r_delta, r_gap = ref_gap(_j(ds.X), _j(ds.y), _j(w), jnp.asarray(0.1),
                                jnp.asarray(0.3 * lmax, jnp.float32))
    assert math.isinf(float(delta)) and math.isinf(float(gap))
    assert math.isinf(float(r_delta)) and math.isinf(float(r_gap))


# -- the refresh bound -------------------------------------------------------

def _refresh_case(X, y, case):
    """``(X, y, sample_mask, live rows)`` of one refresh: the full problem,
    a gather bucket (kept rows and columns, zero padding on both axes, y = 0
    and mask 0 on the padded columns) or mask mode (screened rows zeroed,
    a sample mask)."""
    m, n = X.shape
    rng = np.random.default_rng(5)
    if case == "none":
        return X, y, None, m
    if case == "gather":
        f_idx = np.sort(rng.choice(m, 150, replace=False))
        s_idx = np.sort(rng.choice(n, 100, replace=False))
        Xb = torch.zeros((256, 128))
        Xb[:150, :100] = X[f_idx][:, s_idx]
        yb = torch.zeros(128)
        yb[:100] = y[s_idx]
        sm = torch.zeros(128)
        sm[:100] = 1.0
        return Xb, yb, sm, 150
    f_mask = torch.from_numpy((rng.random(m) < 0.6).astype(np.float32))
    return X * f_mask[:, None], y, torch.from_numpy(_sample_mask(n, 3)), m


@pytest.mark.parametrize("case", ["none", "gather", "mask"])
def test_refresh_bounds_match_reference(inst, case):
    ds, X, y, L, lmax = inst
    lam = 0.3 * lmax
    Xc, yc, sm, live = _refresh_case(X, y, case)
    it = fista_solve(Xc, yc, lam, max_iters=30, L=L, sample_mask=sm)
    smv = np.ones(Xc.shape[1], np.float32) if sm is None else sm.numpy()
    r_theta, r_delta, _ = ref_gap(_j(Xc), _j(yc), _j(it.w), jnp.asarray(float(it.b)),
                                  jnp.asarray(lam, jnp.float32),
                                  None if sm is None else _j(sm))
    theta = torch.from_numpy(np.array(r_theta))
    delta = torch.tensor(float(r_delta))
    want = _ref_refresh(Xc, yc, lam, theta, delta, smv)
    got = refresh_bounds(Xc, yc, lam, theta, delta, sm)
    _close(got, want)
    # the solver screens a bucket's live rows only: the same bounds there
    _close(refresh_bounds(Xc[:live], yc, lam, theta, delta, sm), want[:live])
    assert np.isfinite(want).all()
    if case != "none":  # zero rows bound to 0: they can never be kept
        zero_rows = (Xc.abs().sum(1) == 0).numpy()
        assert zero_rows.any() and float(got[zero_rows].abs().max()) == 0.0


# -- the dynamic variant of the feature-screen kernel: plain version ----------

def _kernel_inputs(m, n, dtype, seed):
    ds = make_sparse_classification(m=m, n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    X = torch.from_numpy(ds.X).to(dtype)
    y = torch.from_numpy(ds.y)
    s = torch.from_numpy(_sample_mask(n, seed + 2))
    theta = torch.from_numpy((rng.random(n) / 3.0).astype(np.float32)) * s
    return X, y, s, theta


def _port_shared(y, lam, theta, delta, s):
    w = torch.ones_like(y) if s is None else s
    lam = torch.tensor(lam)
    return shared_scalars_from_stats(
        lam, lam, one_y=torch.sum(y * w), theta_dot_one=torch.sum(theta),
        theta_dot_y=theta @ y, theta_sq=theta @ theta, n_tot=torch.sum(w),
        delta=torch.tensor(delta))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("weighted,capped", [(True, False), (False, True), (True, True)],
                         ids=["weights", "cap", "weights_cap"])
def test_dynamic_screen_plain_matches_reference(shape, dtype, weighted, capped):
    """The kernel's plain version (weights, cap, both) against the
    reference's jnp expression on the same values (bf16 X rounded once, in
    torch, and handed over exactly)."""
    m, n = shape
    X, y, s, theta = _kernel_inputs(m, n, dtype, seed=21)
    lam, delta = 3.0, 0.05
    w = s if weighted else None
    sh = _port_shared(y, lam, theta, delta, w)
    got = screen.screen_bounds_plain(X, y, theta, sh, weights=w,
                                     cap_delta=torch.tensor(delta) if capped else None)
    Xf = X.float().numpy()
    smv = s.numpy() if weighted else np.ones(n, np.float32)
    if capped:
        want = _ref_refresh(Xf, y, lam, theta, delta, smv)
    else:
        Xj, yj, tj, sj = _j(Xf), _j(y), _j(theta), _j(smv)
        lam_j = jnp.asarray(lam, jnp.float32)
        sh_r = ref_stats(lam_j, lam_j, one_y=jnp.sum(yj * sj), theta_dot_one=jnp.sum(tj),
                         theta_dot_y=tj @ yj, theta_sq=tj @ tj, n_tot=jnp.sum(sj),
                         delta=jnp.asarray(delta, jnp.float32))
        red = RefReductions(d_theta=Xj @ (yj * tj), d_one=Xj @ (yj * sj),
                            d_y=Xj @ sj, d_sq=(Xj * Xj) @ sj)
        want = np.asarray(ref_from_reductions(red, sh_r))
    _close(got, want)


def test_dynamic_screen_plain_propagates_nan_and_inf():
    """A NaN theta gives NaN bounds (the caller keeps them); delta = inf
    gives the reference's inf/NaN pattern, which ``~isfinite(delta)`` keeps."""
    X, y, s, theta = _kernel_inputs(64, 64, torch.float32, seed=22)
    bad = theta.clone()
    bad[5] = float("nan")
    out = screen.screen_bounds_plain(X, y, bad, _port_shared(y, 3.0, bad, 0.05, s),
                                     weights=s, cap_delta=torch.tensor(0.05))
    assert bool(torch.isnan(out).all())
    inf = float("inf")
    out = screen.screen_bounds_plain(X, y, theta, _port_shared(y, 3.0, theta, inf, s),
                                     weights=s, cap_delta=torch.tensor(inf))
    want = _ref_refresh(X.numpy(), y, 3.0, theta, inf, s.numpy())
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(want))
    assert not np.isfinite(want).any()
    assert not bool((out < SAFE_TAU).any())  # nothing is screened


def test_pack_shared_cap_slots():
    _, y, s, theta = _kernel_inputs(64, 64, torch.float32, seed=23)
    sh = _port_shared(y, 3.0, theta, 0.05, s)
    assert screen.pack_shared(sh)[10:].tolist() == [0.0, 0.0]
    assert screen.pack_shared(sh, torch.tensor(0.25))[10:].tolist() == [1.0, 0.25]


# -- D1/D2: the dynamic solver ------------------------------------------------

@pytest.fixture(scope="module")
def dyn25(inst):
    """Port and reference dynamic solves at 0.25 lam_max (tol 1e-11)."""
    ds, X, y, L, lmax = inst
    lam = 0.25 * lmax
    port = fista_solve_dynamic(X, y, lam, max_iters=20000, tol=1e-11,
                               screen_every=20, L=L)
    ref = ref_dynamic(_j(ds.X), _j(ds.y), lam, max_iters=20000, tol=1e-11,
                      screen_every=20, L=jnp.asarray(L, jnp.float32))
    return port, ref


def test_dynamic_solver_matches_reference(inst, dyn25):
    _, X, y, L, lmax = inst
    port, ref = dyn25
    np.testing.assert_allclose(port.obj, float(ref.obj), rtol=1e-6)
    np.testing.assert_allclose(port.w.numpy(), np.asarray(ref.w), atol=1e-4)
    static = fista_solve(X, y, 0.25 * lmax, max_iters=20000, tol=1e-11, L=L)
    np.testing.assert_allclose(port.obj, static.obj, rtol=1e-6)
    np.testing.assert_allclose(port.w.numpy(), static.w.numpy(), atol=1e-4)


def test_dynamic_solver_tightens_and_keeps_sentinels(inst, dyn25):
    X = inst[1]
    port, _ = dyn25
    s = port.n_segments
    kept, gaps = port.kept_per_segment[:s], port.gap_per_segment[:s]
    assert len(port.kept_per_segment) == math.ceil(20000 / 20)
    assert s >= 2
    assert np.all(np.diff(kept) <= 0), kept           # the mask only shrinks
    assert kept[-1] < X.shape[0], kept                # and it does shrink
    assert kept[-1] == int(port.feature_mask.sum())
    assert np.all(np.isfinite(gaps)) and np.all(gaps >= 0.0)
    assert np.all(port.kept_per_segment[s:] == -1)    # unused slots
    assert np.all(np.isinf(port.gap_per_segment[s:]))
    assert port.sample_mask is None and port.kept_samples_per_segment is None
    assert port.health == 0


def test_dynamic_screened_features_truly_inactive(inst):
    ds, X, y, L, lmax = inst
    lam = 0.3 * lmax
    dyn = fista_solve_dynamic(X, y, lam, max_iters=20000, tol=1e-11,
                              screen_every=20, L=L)
    screened = ~dyn.feature_mask.numpy()
    assert screened.any()
    full = ref_fista(_j(ds.X), _j(ds.y), lam, max_iters=60000, tol=1e-13,
                     L=jnp.asarray(L, jnp.float32))
    assert np.abs(np.asarray(full.w))[screened].max() <= 1e-6
    assert float(dyn.w[torch.from_numpy(screened)].abs().max()) == 0.0


def test_dynamic_solver_respects_seed_mask(inst):
    ds, X, y, L, lmax = inst
    m = X.shape[0]
    lam = 0.3 * lmax
    seed = np.ones((m,), np.float32)
    seed[: m // 4] = 0.0  # a sequential screen dropped these
    Xm = X * torch.from_numpy(seed)[:, None]
    dyn = fista_solve_dynamic(Xm, y, lam, max_iters=20000, tol=1e-11,
                              screen_every=20, feature_mask=torch.from_numpy(seed), L=L)
    # seeded zeros never come back, not even as -0.0 or a tiny leak
    assert not dyn.feature_mask[: m // 4].any()
    assert float(dyn.w[: m // 4].abs().max()) == 0.0
    ref = ref_dynamic(_j(Xm), _j(ds.y), lam, max_iters=20000, tol=1e-11,
                      screen_every=20, feature_mask=_j(seed),
                      L=jnp.asarray(L, jnp.float32))
    np.testing.assert_allclose(dyn.obj, float(ref.obj), rtol=1e-6)
    np.testing.assert_allclose(dyn.w.numpy(), np.asarray(ref.w), atol=1e-4)


def test_dynamic_solver_gather_bucket_keeps_padding_out(inst):
    """A gather bucket: rows past valid_m stay out of the live mask, and
    the solve equals the one on the live rows alone."""
    _, X, y, L, lmax = inst
    lam = 0.3 * lmax
    Xb = torch.zeros((512, X.shape[1]))
    Xb[:400] = X
    dyn = fista_solve_dynamic(Xb, y, lam, max_iters=20000, tol=1e-11,
                              screen_every=20, L=L, valid_m=400)
    plain = fista_solve_dynamic(X, y, lam, max_iters=20000, tol=1e-11,
                                screen_every=20, L=L)
    assert not dyn.feature_mask[400:].any()
    assert dyn.kept_per_segment[0] <= 400
    np.testing.assert_allclose(dyn.obj, plain.obj, rtol=1e-6)
    np.testing.assert_allclose(dyn.w[:400].numpy(), plain.w.numpy(), atol=1e-4)


def test_refused_refresh_flags_health_and_solve_goes_on(inst, monkeypatch):
    """A non-finite certificate keeps every feature, sets the refusal bit,
    and does not count as a guard trip: the solve still converges."""
    _, X, y, L, lmax = inst
    lam = 0.25 * lmax
    real = tsolver.gap_theta_delta

    def refused(*a, **kw):
        theta, delta, gap = real(*a, **kw)
        return theta, torch.full_like(delta, float("inf")), torch.full_like(gap, float("inf"))

    monkeypatch.setattr(tsolver, "gap_theta_delta", refused)
    dyn = fista_solve_dynamic(X, y, lam, max_iters=20000, tol=1e-11,
                              screen_every=5, L=L)
    assert dyn.health == HEALTH_SCREEN_REFUSED
    assert dyn.n_iters > 5 and dyn.converged
    assert bool(dyn.feature_mask.all())
    assert np.all(dyn.kept_per_segment[:dyn.n_segments] == X.shape[0])
    static = fista_solve(X, y, lam, max_iters=20000, tol=1e-11, L=L)
    np.testing.assert_allclose(dyn.obj, static.obj, rtol=1e-6)


# -- DS: the dynamic sample re-screen -----------------------------------------

def test_dynamic_sample_solver_screens_and_verifies(inst):
    """Warm-started at the optimum with (essentially) zero radii the margin
    prediction is exact: every screened sample has margin >= 1 there, and
    the objective does not move."""
    ds, X, y, L, lmax = inst
    lam = 0.15 * lmax
    ref = ref_fista(_j(ds.X), _j(ds.y), lam, max_iters=40000, tol=1e-12,
                    L=jnp.asarray(L, jnp.float32))
    w0 = torch.from_numpy(np.array(ref.w))
    kw = dict(max_iters=20000, tol=1e-11, screen_every=10, dynamic_samples=True,
              sample_dw=1e-4, sample_db=1e-4)
    dyn = fista_solve_dynamic(X, y, lam, w0=w0, b0=float(ref.b), L=L, **kw)
    assert dyn.sample_mask is not None
    screened = ~dyn.sample_mask.numpy()
    assert screened.any(), "no sample screened with zero-movement radii"
    margins = ds.y * (ds.X.T @ np.asarray(ref.w) + float(ref.b))
    assert margins[screened].min() >= 1.0 - 1e-4
    np.testing.assert_allclose(dyn.obj, float(ref.obj), rtol=1e-5)
    s = dyn.n_segments
    kept_s = dyn.kept_samples_per_segment[:s]
    assert np.all(np.diff(kept_s) <= 0)  # the sample mask only shrinks
    assert np.all(dyn.kept_samples_per_segment[s:] == -1)
    r_dyn = ref_dynamic(_j(ds.X), _j(ds.y), lam, w0=ref.w, b0=ref.b,
                        L=jnp.asarray(L, jnp.float32), **kw)
    np.testing.assert_allclose(dyn.obj, float(r_dyn.obj), rtol=1e-6)


# -- D3: the dynamic path -----------------------------------------------------

@pytest.fixture(scope="module")
def paths(inst):
    ds, _, _, L, _ = inst
    out = {}
    for reduce in REDUCE:
        kw = dict(reduce=reduce, L=L, **PATH_KW)
        out[reduce] = (
            PathDriver("feature_vi", device="cpu", **kw).run(ds.X, ds.y, **GRID),
            PathDriver("feature_vi", dynamic=True, screen_every=25, device="cpu",
                       **kw).run(ds.X, ds.y, **GRID),
            RefDriver("feature_vi", dynamic=True, screen_every=25, **kw).run(
                ds.X, ds.y, **GRID))
    out["unscreened"] = PathDriver([], L=L, device="cpu", **PATH_KW).run(
        ds.X, ds.y, **GRID)
    return out


@pytest.mark.parametrize("reduce", REDUCE)
def test_dynamic_path_matches_sequential_and_reference(paths, reduce):
    seq, dyn, ref = paths[reduce]
    np.testing.assert_allclose(dyn.objectives, seq.objectives, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dyn.weights, seq.weights, atol=3e-3)
    # the stop rule's fp32 stall scale (see the module docstring)
    np.testing.assert_allclose(dyn.objectives, ref.objectives, rtol=1e-5)
    np.testing.assert_allclose(dyn.weights, ref.weights, atol=3e-3)
    tele = dyn.extras["dynamic"]
    assert sorted(tele) == list(range(1, len(dyn.lambdas)))
    # in-solve tightening: some step ends with fewer live features than its
    # between-lambda screen fed the solver
    assert any(d["kept_per_segment"] and d["kept_per_segment"][-1] < dyn.kept[k]
               for k, d in tele.items()), tele
    for k, d in tele.items():
        assert d["segments"] == len(d["kept_per_segment"]) == len(d["gap_per_segment"])
        assert d["kept_per_segment"][-1] == int(dyn.extras["dynamic_keep_masks"][k].sum())
    assert not np.any(dyn.extras["health"])


@pytest.mark.parametrize("rules", ["feature_vi", "composite"])
@pytest.mark.parametrize("reduce", REDUCE)
def test_dynamic_path_matches_reference_at_fixed_iterations(inst, rules, reduce):
    """300 FISTA iterations a step in both packages (the stop rule out of
    play): the dynamic paths agree to rel 1e-6."""
    ds, _, _, L, _ = inst
    kw = dict(reduce=reduce, L=L, tol=-1.0, max_iters=300, dynamic=True,
              screen_every=25)
    port = PathDriver(rules, device="cpu", **kw).run(ds.X, ds.y, **GRID)
    ref = RefDriver(rules, **kw).run(ds.X, ds.y, **GRID)
    np.testing.assert_allclose(port.objectives, ref.objectives, rtol=1e-6)
    np.testing.assert_allclose(port.weights, ref.weights, atol=3e-3)
    assert all(d["kept_per_segment"][-1] < port.kept[k]
               for k, d in port.extras["dynamic"].items() if k >= 1)


@pytest.mark.parametrize("reduce", REDUCE)
def test_dynamic_path_is_safe(paths, reduce):
    """No feature that is nonzero in the unscreened solve was screened,
    between the steps or inside a solve."""
    _, dyn, _ = paths[reduce]
    full = paths["unscreened"]
    live = dyn.extras["dynamic_keep_masks"]
    for k in range(1, len(dyn.lambdas)):
        w = np.abs(full.weights[k])
        support = w > 1e-6 * w.max()
        assert not np.any(support & ~live[k]), k
        assert not np.any(live[k] & ~dyn.extras["keep_masks"][k])  # only shrinks


def test_dynamic_composite_mask_path_screens_samples_and_matches(inst):
    """Composite rule in mask mode with the in-solver sample re-screen:
    the accepted path equals the port's sequential one and the reference's
    dynamic one, the telemetry shows the sample counts, and every screened
    sample has zero slack at the accepted solution (float64)."""
    ds, _, _, L, _ = inst
    kw = dict(reduce="mask", L=L, **PATH_KW)
    seq = PathDriver("composite", device="cpu", **kw).run(ds.X, ds.y, **GRID)
    dyn = PathDriver("composite", dynamic=True, screen_every=25, device="cpu",
                     **kw).run(ds.X, ds.y, **GRID)
    ref = RefDriver("composite", dynamic=True, screen_every=25, **kw).run(
        ds.X, ds.y, **GRID)
    for other in (seq, ref):
        np.testing.assert_allclose(dyn.objectives, other.objectives, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(dyn.weights, other.weights, atol=3e-3)
    tele = dyn.extras["dynamic"]
    assert all("kept_samples_per_segment" in d for d in tele.values()), tele
    assert any(d["kept_samples_per_segment"][-1] < ds.X.shape[1]
               for d in tele.values()), tele
    X64, y64 = ds.X.astype(np.float64), ds.y.astype(np.float64)
    for k, mask in dyn.extras["sample_masks"].items():
        xi = np.maximum(0.0, 1.0 - y64 * (X64.T @ dyn.weights[k] + dyn.biases[k]))
        assert xi[~mask].max(initial=0.0) <= 1e-6, k


def test_dynamic_tau_is_the_smallest_feature_tau():
    assert dynamic_tau([]) == SAFE_TAU
    assert dynamic_tau([FeatureVIRule(tau=0.99), DVIRule(tau=0.97),
                        get_rule("sample_vi")]) == 0.97


# -- D4: the refresh hook -----------------------------------------------------

def test_refresh_region_matches_reference_and_tightens(inst):
    ds, X, y, L, lmax = inst
    lam1, lam2 = 0.5 * lmax, 0.3 * lmax
    Lj = jnp.asarray(L, jnp.float32)
    res1 = ref_fista(_j(ds.X), _j(ds.y), jnp.asarray(lam1), max_iters=40000,
                     tol=1e-13, L=Lj)
    res2 = ref_fista(_j(ds.X), _j(ds.y), jnp.asarray(lam2), max_iters=40000,
                     tol=1e-13, L=Lj)
    w2, b2 = torch.from_numpy(np.array(res2.w)), float(res2.b)
    rule = FeatureVIRule()
    region = rule.refresh(X, y, w2, b2, lam2)
    assert region.lam1 == region.lam2 == pytest.approx(lam2)
    r_region = RefFeatureRule().refresh(_j(ds.X), _j(ds.y), res2.w, res2.b, lam2)
    _close(region.theta1, r_region.theta1)
    bounds = rule.bounds(X, y, region)
    keep = rule.keep(bounds).numpy()
    support = np.abs(np.asarray(res2.w)) > 1e-7
    assert np.all(keep[support]), "refresh screened an active feature"
    theta1, delta1 = ref_certify(_j(ds.X), _j(ds.y), res1.w, res1.b, jnp.asarray(lam1))
    seq = ConvexRegion.build(y, lam1, lam2, torch.from_numpy(np.array(theta1)),
                             delta=torch.tensor(float(delta1)))
    assert keep.sum() <= rule.keep(rule.bounds(X, y, seq)).numpy().sum()


# -- V1: the DVI rule ---------------------------------------------------------

def test_dvi_registered_and_no_looser_than_feature_vi(inst):
    ds, _, _, L, _ = inst
    assert "dvi" in available_rules()
    assert isinstance(get_rule("dvi"), DVIRule)
    kw = dict(L=L, device="cpu", **PATH_KW)
    fv = PathDriver("feature_vi", **kw).run(ds.X, ds.y, **GRID)
    dvi = PathDriver("dvi", **kw).run(ds.X, ds.y, **GRID)
    off = PathDriver([], **kw).run(ds.X, ds.y, **GRID)
    np.testing.assert_allclose(dvi.objectives, off.objectives, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dvi.weights, off.weights, atol=3e-3)
    assert np.all(dvi.kept <= fv.kept)
    for k in range(1, len(dvi.lambdas)):  # safe against the unscreened path
        w = np.abs(off.weights[k])
        assert not np.any((w > 1e-6 * w.max()) & ~dvi.extras["keep_masks"][k])


def test_dvi_bounds_match_reference_on_reference_anchors(inst):
    """Two steps of the rule on the reference's own anchors: the second
    step's bound is the min over both anchors, in both packages."""
    ds, X, y, L, lmax = inst
    lams = [lmax, 0.6 * lmax, 0.4 * lmax]
    Lj = jnp.asarray(L, jnp.float32)
    port, ref = DVIRule(), RefDVIRule()
    port.prepare(X, y)
    ref.prepare(_j(ds.X), _j(ds.y))
    theta_j, delta_j = ref_theta_max(_j(ds.y), jnp.asarray(lmax)), jnp.asarray(0.0)
    for k in (1, 2):
        theta = torch.from_numpy(np.array(theta_j))
        delta = torch.tensor(float(delta_j))
        region = ConvexRegion.build(y, lams[k - 1], lams[k], theta, delta=delta)
        r_region = RefRegion.build(_j(ds.y), lams[k - 1], lams[k], theta_j,
                                   delta=delta_j)
        got = port.bounds(X, y, region)
        want = np.asarray(ref.bounds(_j(ds.X), _j(ds.y), r_region), np.float64)
        _close(got, want, rel=1e-4)
        differ = port.keep(got).numpy() != (want >= SAFE_TAU)
        assert not np.any(differ & (np.abs(want - SAFE_TAU) > 1e-4 * SAFE_TAU))
        fv = FeatureVIRule().bounds(X, y, region)
        assert bool((got <= fv).all())
        res = ref_fista(_j(ds.X), _j(ds.y), jnp.asarray(lams[k]), max_iters=40000,
                        tol=1e-12, L=Lj)
        theta_j, delta_j = ref_certify(_j(ds.X), _j(ds.y), res.w, res.b,
                                       jnp.asarray(lams[k]))
    assert port._anchor is not None
    port.prepare(X, y)
    assert port._anchor is None


# -- the launcher -------------------------------------------------------------

def test_launcher_dynamic_composite_mask(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the launcher writes artifacts/ here
    rc = train_main(["--m", "300", "--n", "120", "--dynamic", "--screen-every", "25",
                     "--rules", "composite", "--reduce", "mask",
                     "--lam-min-ratio", "0.02", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "dynamic=True" in out
    steps = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(steps) == 8
    assert all("kept_per_segment=[" in ln for ln in steps[1:])


def test_launcher_dvi(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the launcher writes artifacts/ here
    assert train_main(["--m", "300", "--n", "120", "--rules", "dvi",
                       "--device", "cpu"]) == 0
    assert "rules=dvi" in capsys.readouterr().out
