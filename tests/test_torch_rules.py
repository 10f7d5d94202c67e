"""The rest of the feature-rule zoo in the port (rule programs, ``edpp``,
``auto``, ``sifs``) against the reference.

Inputs are made with numpy and handed to both packages. Tolerances:

* region statistics and VI bounds: rtol 1e-4 with an absolute floor of
  1e-4 of their scale, as ``tests/test_torch_screening.py`` (fp32 sums in
  other orders, then the closed form's cancellations);
* EDPP bounds on the reference's anchors: the same rtol 1e-4; the port's
  EDPP bound is never above its VI bound, exactly;
* paths: objectives rel 1e-6 at fixed FISTA iterations (``tol=-1``, the
  stop rule out of play) and rel 1e-5 at the default stop rule (the
  reference's own host-vs-scan spread is 7.9e-6); both packages get the
  same L;
* every screened sample has ``xi <= 1e-6`` at the accepted solution, in
  float64.

``_problem`` is the reference's ``tests/test_rule_programs.py`` instance
generator (float64 numpy, handed over as float32, as the reference's
float32 JAX arrays hold it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dual import lambda_max as ref_lambda_max
from repro.core.dual import safe_theta_and_delta as ref_certify
from repro.core.dual import theta_at_lambda_max as ref_theta_max
from repro.core.path import PathDriver as RefDriver
from repro.core.rules import PROGRAMS as REF_PROGRAMS
from repro.core.rules import AutoRule as RefAutoRule
from repro.core.rules import make_rules as ref_make_rules
from repro.core.rules import resolve_programs as ref_resolve
from repro.core.screening import anchor_stats as ref_anchor_stats
from repro.core.screening import feature_reductions as ref_reductions
from repro.core.screening import finalize_from_anchor as ref_finalize
from repro.core.screening import fixed_stats as ref_fixed_stats
from repro.core.screening import shared_scalars as ref_shared
from repro.core.solver import fista_solve as ref_fista
from repro_torch.core import screening as ts
from repro_torch.core.path import PathDriver, svm_path
from repro_torch.core.rules import (
    PROGRAMS,
    AutoRule,
    CompositeRule,
    ConvexRegion,
    DVIRule,
    EDPPRule,
    FeatureVIRule,
    RuleProgram,
    SampleVIRule,
    SIFSRule,
    available_rules,
    make_rules,
    resolve_programs,
    stack_bounds,
    stack_needs_history,
)
from repro_torch.core.rules.programs import max_anchors
from repro_torch.core.solver import lipschitz_estimate
from repro_torch.data import make_sparse_classification
from repro_torch.kernels import ops, screen
from repro_torch.launch.train_svm import main as train_main

RTOL = 1e-4
FEATURE_GRID = dict(n_lambdas=10, lam_min_ratio=0.3)
DEEP = dict(n_lambdas=8, lam_min_ratio=0.02)
FIXED_300 = dict(tol=-1.0, max_iters=300)


def _problem(m=150, n=90, seed=0, planted=0):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float64)
    if planted:
        w = np.zeros(m)
        w[:planted] = rng.normal(size=planted) * 3
        y = np.sign(X.T @ w + 0.1 * rng.normal(size=n))
    else:
        y = np.sign(rng.normal(size=n))
        y[y == 0] = 1.0
    return X.astype(np.float32), y.astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _close(port, reference, rtol=RTOL):
    reference = np.asarray(reference, np.float64)
    np.testing.assert_allclose(np.asarray(port, np.float64), reference, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(reference).max())))


def _xi64(X, y, w, b):
    return np.maximum(0.0, 1.0 - y.astype(np.float64)
                      * (X.astype(np.float64).T @ w + b))


def _support(weights):
    w = np.abs(weights)
    return w > 1e-6 * w.max() if w.max() > 0 else np.zeros_like(w, bool)


# -- the program registry and resolve_programs --------------------------------

def test_program_registry_matches_reference():
    assert sorted(PROGRAMS) == sorted(REF_PROGRAMS)
    for name, prog in PROGRAMS.items():
        assert isinstance(prog, RuleProgram) and prog.name == name
        assert prog.n_anchors == REF_PROGRAMS[name].n_anchors
    assert stack_needs_history([PROGRAMS["dvi"]])
    assert not stack_needs_history([PROGRAMS["feature_vi"], PROGRAMS["edpp"]])
    assert max_anchors([]) == 1
    # every rule the reference registers, the port now registers too
    assert {"feature_vi", "dvi", "edpp", "auto", "sample_vi", "composite",
            "sifs"} <= set(available_rules())
    programs = {nm: getattr(make_rules(nm)[0], "program", None)
                for nm in ("feature_vi", "dvi", "edpp", "auto")}
    assert programs == {"feature_vi": "feature_vi", "dvi": "dvi", "edpp": "edpp",
                        "auto": "edpp"}
    assert SampleVIRule.program is None and CompositeRule.program is None
    assert SIFSRule.program is None


@pytest.mark.parametrize("spec", [None, "none", "", "feature_vi", "edpp", "auto",
                                  "dvi", ["edpp", "feature_vi", "edpp"],
                                  ["auto", "edpp"]])
def test_resolve_programs_matches_reference(spec):
    assert resolve_programs(spec) == ref_resolve(spec)
    assert resolve_programs(spec, screening=False) == ref_resolve(spec, screening=False)


@pytest.mark.parametrize("spec", ["sifs", "composite", "sample_vi",
                                  ["edpp", "sample_vi"]])
def test_resolve_programs_rejects_what_needs_verification(spec):
    with pytest.raises(ValueError, match="sample_vi"):
        resolve_programs(spec)
    with pytest.raises(ValueError):
        ref_resolve(spec)


def test_resolve_programs_flattens_feature_containers():
    spec = CompositeRule([FeatureVIRule(), EDPPRule(), DVIRule(), EDPPRule()])
    assert resolve_programs(spec) == ("feature_vi", "edpp", "dvi")
    assert resolve_programs(SIFSRule(rules=[EDPPRule()])) == ("edpp",)
    assert resolve_programs(None) == ("feature_vi",)
    assert resolve_programs("auto") == ("edpp",)


def test_make_rules_flattens_sifs_as_reference():
    rules = make_rules("sifs")
    assert [type(r) for r in rules] == [EDPPRule, SampleVIRule]
    assert [r.name for r in rules] == [r.name for r in ref_make_rules("sifs")]
    assert [r.axis for r in rules] == ["features", "samples"]
    assert rules[1].needs_verification
    assert make_rules(SIFSRule(tau=0.9))[0].tau == 0.9


# -- anchors: the region statistics and the EDPP bound -----------------------

def _anchor(kind, seed=0):
    """(X, y, lam1, lam2, theta1, delta) as numpy. 'lam_max': the exact
    anchor at lam_max (delta 0); 'solved': a certified anchor from an
    approximate solve (delta > 0); 'random': an arbitrary positive theta1
    with delta 0.03; 'lam_max_balanced': the exact anchor at lam_max with
    exactly balanced classes (theta1 = o1: the degenerate v1); 'nan':
    'random' with one NaN entry."""
    ds = make_sparse_classification(m=240, n=90, seed=seed)
    X, y = ds.X, ds.y.copy()
    rng = np.random.default_rng(seed + 100)
    if kind == "lam_max_balanced":
        y[:] = -1.0
        y[rng.permutation(len(y))[: len(y) // 2]] = 1.0
    lmax = float(ref_lambda_max(jnp.asarray(X), jnp.asarray(y)))
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
        lam1, delta = 0.7 * lmax, 0.03
        theta1 = (np.abs(rng.standard_normal(len(y))) / lam1).astype(np.float32)
        if kind == "nan":
            theta1[7] = np.nan
    return X, y, lam1, 0.6 * lam1, theta1.astype(np.float32), delta


def _ref_region(X, y, lam1, theta1, delta):
    X, y, th = jnp.asarray(X), jnp.asarray(y), jnp.asarray(theta1)
    red = ref_reductions(X, y, th)
    return (ref_anchor_stats(y, lam1, th, delta, red.d_theta),
            ref_fixed_stats(y, red.d_one, red.d_y, red.d_sq))


def _port_region(X, y, lam1, theta1, delta):
    X, y, th = (torch.from_numpy(a) for a in (X, y, theta1))
    red = ts.feature_reductions(X, y, th)
    return (ts.anchor_stats(y, lam1, th, delta, red.d_theta),
            ts.fixed_stats(y, red.d_one, red.d_y, red.d_sq))


@pytest.mark.parametrize("kind", ["solved", "random", "lam_max_balanced"])
def test_anchor_and_fixed_stats_match_reference(kind):
    X, y, lam1, lam2, theta1, delta = _anchor(kind)
    a_r, f_r = _ref_region(X, y, lam1, theta1, delta)
    a_p, f_p = _port_region(X, y, lam1, theta1, delta)
    for name in a_p._fields:
        _close(getattr(a_p, name), getattr(a_r, name))
    for name in f_p._fields:
        _close(getattr(f_p, name), getattr(f_r, name))
    lam2_j = jnp.asarray(lam2, jnp.float32)
    _close(ts.finalize_from_anchor(a_p, lam2, f_p), ref_finalize(a_r, lam2_j, f_r))
    # the anchor entry and the in-core entry run the same scalar arithmetic
    th = torch.from_numpy(theta1)
    sh = ts.shared_scalars(torch.from_numpy(y), lam1, lam2, th, delta=delta)
    sh_a = ts.shared_scalars_from_anchor(a_p, lam2, f_p)
    for name in sh._fields:
        assert torch.equal(getattr(sh, name), getattr(sh_a, name)), name
    sh_r = ref_shared(jnp.asarray(y), lam1, lam2, jnp.asarray(theta1), delta=delta)
    # at theta1 = o1 the halfspace normal is rounding noise in both packages
    names = ("yc", "r_h_sq") + (("g0", "qa_sq", "a_norm", "a_dot_y")
                                if bool(sh.halfspace_valid) else ())
    for name in names:
        _close(getattr(sh, name), getattr(sh_r, name))


@pytest.mark.parametrize("kind", ["lam_max", "solved", "random", "lam_max_balanced"])
def test_edpp_bounds_match_reference_on_reference_anchors(kind):
    """The port's EDPPRule on the reference's anchor against the reference's
    ``PROGRAMS["edpp"]``; the port's EDPP bound is at most its VI bound on
    the same anchor, bit for bit, and equals the ``edpp`` program."""
    X, y, lam1, lam2, theta1, delta = _anchor(kind)
    a_r, f_r = _ref_region(X, y, lam1, theta1, delta)
    want = REF_PROGRAMS["edpp"].bounds(jnp.asarray(lam2, jnp.float32), (a_r,), f_r)
    Xt, yt, tht = (torch.from_numpy(a) for a in (X, y, theta1))
    region = ConvexRegion.build(yt, lam1, lam2, tht, delta=delta)
    before = dict(ops.launch_counts())
    got = EDPPRule().bounds(Xt, yt, region)
    vi = FeatureVIRule().bounds(Xt, yt, region)
    assert ops.launch_counts() == before  # a CPU X runs the plain version
    _close(got, want)
    assert bool((got <= vi).all())
    a_p, f_p = _port_region(X, y, lam1, theta1, delta)
    assert torch.equal(got, stack_bounds(("edpp",), lam2, (a_p,), f_p))
    assert torch.equal(vi, stack_bounds(("feature_vi",), lam2, (a_p,), f_p))
    if kind == "lam_max_balanced":
        # v1 = o1 - theta1 = 0: mu = 0, the DPP ball; the halfspace is
        # vacuous there too, so the two bounds agree up to rounding
        e = ts.edpp_scalars(yt, lam1, lam2, tht, delta)
        assert float(e.mu) == 0.0
        _close(got, vi, rtol=1e-6)


def _masked_anchor(kind, m, seed):
    """(X, y, s, lam1, lam2, theta1, delta) for a problem whose live samples
    are the 0/1 mask ``s`` (about 70% of 90 columns; the masked columns of
    X keep their values, so only the weights remove them), the anchor taken
    on the live columns and zero on the others, as a certificate under a
    sample mask gives it: 'lam_max' the exact anchor, 'solved' a certified
    one from an approximate solve, 'random' a positive theta1 with delta
    0.03."""
    ds = make_sparse_classification(m=m, n=90, seed=seed)
    X, y = ds.X, ds.y
    rng = np.random.default_rng(seed + 200)
    live = rng.random(90) < 0.7
    Xl, yl = jnp.asarray(X[:, live]), jnp.asarray(y[live])
    lmax = float(ref_lambda_max(Xl, yl))
    if kind == "lam_max":
        lam1, delta = lmax, 0.0
        th = np.asarray(ref_theta_max(yl, jnp.asarray(lmax)))
    elif kind == "solved":
        lam1 = 0.6 * lmax
        res = ref_fista(Xl, yl, lam1, max_iters=300)
        th, delta = ref_certify(Xl, yl, res.w, res.b, jnp.asarray(lam1))
        th, delta = np.asarray(th), float(delta)
    else:
        lam1, delta = 0.7 * lmax, 0.03
        th = np.abs(rng.standard_normal(int(live.sum()))) / lam1
    theta1 = np.zeros(90, np.float32)
    theta1[live] = th
    return X, y, live.astype(np.float32), lam1, 0.6 * lam1, theta1, delta


@pytest.mark.parametrize("m", [240, 243], ids=["dense", "ragged"])
@pytest.mark.parametrize("kind,seed", [("lam_max", 0), ("solved", 1), ("random", 2),
                                       ("random", 3)])
def test_weighted_edpp_plain_matches_reference(kind, seed, m):
    """The weighted EDPP mode's plain version (the path server's sample-masked
    slots) against the reference's ``stack_bounds(("edpp",), ...)`` on
    ``FixedStats`` from the masked reductions ``X (y s)``, ``X s``,
    ``(X * X) s``, ``y.s`` and ``sum(s)``, at the unweighted EDPP test's
    tolerance; it is the unweighted bound of the problem with the masked
    columns removed (rtol 1e-5), and never above the weighted VI bound on
    the same anchor, exactly."""
    from repro.core.rules.programs import stack_bounds as ref_stack_bounds
    from repro.core.screening import FixedStats as RefFixedStats

    X, y, s, lam1, lam2, theta1, delta = _masked_anchor(kind, m, seed)
    Xj, yj, sj, thj = (jnp.asarray(a) for a in (X, y, s, theta1))
    anchor = ref_anchor_stats(yj, lam1, thj, delta, Xj @ (yj * thj))
    fixed = RefFixedStats(d_one=Xj @ (yj * sj), d_y=Xj @ sj, d_sq=(Xj * Xj) @ sj,
                          one_y=yj @ sj, n_tot=jnp.sum(sj))
    want = ref_stack_bounds((REF_PROGRAMS["edpp"],), jnp.asarray(lam2, jnp.float32),
                            (anchor,), fixed)

    Xt, yt, st, tht = (torch.from_numpy(a) for a in (X, y, s, theta1))
    kw = dict(lam1=torch.tensor(lam1), lam2=torch.tensor(lam2), one_y=yt @ st,
              theta_dot_one=torch.sum(tht), theta_dot_y=tht @ yt, theta_sq=tht @ tht,
              n_tot=torch.sum(st), delta=torch.tensor(delta))
    sh, e = ts.shared_scalars_from_stats(**kw), ts.edpp_scalars_from_stats(**kw)
    got = screen.screen_bounds_edpp_plain(Xt, yt, tht, sh, e, weights=st)
    _close(got, want)
    assert torch.equal(got, screen.screen_bounds_edpp(Xt, yt, tht, sh, e, weights=st))
    vi = screen.screen_bounds_plain(Xt, yt, tht, sh, weights=st)
    assert bool((got <= vi).all())
    live = st > 0
    reduced = screen.screen_bounds_edpp_plain(
        Xt[:, live].contiguous(), yt[live], tht[live], sh, e)
    _close(got, reduced, rtol=1e-5)


def test_edpp_nan_theta_gives_nan_bounds_that_are_kept():
    X, y, lam1, lam2, theta1, delta = _anchor("nan")
    a_r, f_r = _ref_region(X, y, lam1, theta1, delta)
    want = np.asarray(REF_PROGRAMS["edpp"].bounds(jnp.asarray(lam2, jnp.float32),
                                                  (a_r,), f_r))
    Xt, yt, tht = (torch.from_numpy(a) for a in (X, y, theta1))
    rule = EDPPRule()
    keep, got = rule.screen(Xt, yt, ConvexRegion.build(yt, lam1, lam2, tht, delta=delta))
    assert np.isnan(want).all()
    assert bool(torch.isnan(got).all()) and bool(keep.all())


def test_dvi_program_matches_reference_and_rule():
    """The two-anchor program against the reference's, and against the
    port's stateful DVIRule over the same two anchors."""
    X, y, lam0, _, theta0, delta0 = _anchor("random", seed=1)
    lam1, lam2 = 0.8 * lam0, 0.5 * lam0
    theta1 = (theta0 * 0.9).astype(np.float32)
    a0_r, f_r = _ref_region(X, y, lam0, theta0, delta0)
    a1_r, _ = _ref_region(X, y, lam1, theta1, 0.01)
    want = REF_PROGRAMS["dvi"].bounds(jnp.asarray(lam2, jnp.float32), (a0_r, a1_r), f_r)
    a0, f = _port_region(X, y, lam0, theta0, delta0)
    a1, _ = _port_region(X, y, lam1, theta1, 0.01)
    got = stack_bounds(("dvi",), lam2, (a0, a1), f)
    _close(got, want)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    rule = DVIRule()
    rule.prepare(Xt, yt)
    rule.bounds(Xt, yt, ConvexRegion.build(yt, lam0, lam1, torch.from_numpy(theta0),
                                           delta=delta0))
    b = rule.bounds(Xt, yt, ConvexRegion.build(yt, lam1, lam2, torch.from_numpy(theta1),
                                               delta=0.01))
    _close(b, got, rtol=1e-6)
    # a stack is the min of its programs
    both = stack_bounds([PROGRAMS["edpp"], "dvi"], lam2, (a0, a1), f)
    assert torch.equal(both, torch.minimum(stack_bounds(("edpp",), lam2, (a0, a1), f),
                                           got))


def test_pack_shared_edpp_slots():
    _, y, _, _, theta1, _ = _anchor("random")
    yt, tht = torch.from_numpy(y), torch.from_numpy(theta1)
    sh = ts.shared_scalars(yt, 3.0, 2.0, tht, delta=0.1)
    e = ts.edpp_scalars(yt, 3.0, 2.0, tht, delta=0.1)
    packed = screen.pack_shared(sh, edpp=e)
    assert packed.shape == (screen.NUM_SCALARS_EDPP,) and packed.dtype == torch.float32
    assert torch.equal(packed[:screen.NUM_SCALARS], screen.pack_shared(sh))
    assert packed[12:].tolist() == [float(e.mu), float(e.yc), float(e.r_h_sq), 0.0]


# -- paths: edpp and auto against the reference's host path ------------------

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
def feature_paths():
    """``_problem(m=600, n=200, seed=0, planted=10)``, 10 lambdas at ratio
    0.3 (the reference's EDPP path instance): port and reference for
    ``feature_vi``, ``edpp`` and ``auto`` at the default stop rule and at
    300 fixed iterations, and the port's unscreened path."""
    X, y = _problem(m=600, n=200, seed=0, planted=10)
    L = float(lipschitz_estimate(torch.from_numpy(X)))
    out = {"X": X, "y": y, "L": L}
    for label, kw in (("default", {}), ("fixed", FIXED_300)):
        for rules in ("feature_vi", "edpp", "auto"):
            out[label, rules, "ref"] = RefDriver(rules, L=L, **kw).run(
                X, y, **FEATURE_GRID)
            out[label, rules, "port"] = PathDriver(rules, L=L, device="cpu", **kw).run(
                X, y, **FEATURE_GRID)
    out["unscreened"] = PathDriver([], L=L, device="cpu").run(X, y, **FEATURE_GRID)
    return out


@pytest.mark.parametrize("rules", ["edpp", "auto"])
def test_feature_rule_path_matches_reference(feature_paths, rules):
    p = feature_paths
    assert _rel(p["fixed", rules, "port"].objectives,
                p["fixed", rules, "ref"].objectives) <= 1e-6
    assert _rel(p["default", rules, "port"].objectives,
                p["default", rules, "ref"].objectives) <= 1e-5
    res = p["default", rules, "port"]
    assert res.rules == (rules,) and not np.any(res.extras["health"])
    assert all(rules in t for t in res.extras["rule_telemetry"][1:])


@pytest.mark.parametrize("rules", ["edpp", "auto"])
def test_feature_rule_path_is_safe_and_no_looser_than_vi(feature_paths, rules):
    p = feature_paths
    full = p["unscreened"]
    for label in ("default", "fixed"):
        res = p[label, rules, "port"]
        masks = res.extras["keep_masks"]
        for k in range(1, len(res.lambdas)):
            assert np.all(masks[k][_support(full.weights[k])]), (label, k)
            assert np.all(res.weights[k][~masks[k]] == 0)
        assert int(res.kept.sum()) <= int(p[label, "feature_vi", "port"].kept.sum())
    # on this instance EDPP screens strictly more than VI over the path
    assert (int(p["default", rules, "port"].kept.sum())
            < int(p["default", "feature_vi", "port"].kept.sum()))


def test_auto_rule_telemetry_and_equivalence():
    """The port's counterpart of the reference's test: rules='auto' records
    one telemetry entry per screened step, PathDriver's observe hook feeds
    its cost model, and it solves the same path as feature_vi."""
    X, y = _problem(m=300, n=120, seed=19, planted=8)
    L = float(lipschitz_estimate(torch.from_numpy(X)))
    grid = dict(n_lambdas=8, lam_min_ratio=0.3)
    rule = AutoRule(probe_every=2)
    auto = PathDriver([rule], L=L, device="cpu").run(X, y, **grid)
    ref = PathDriver("feature_vi", L=L, device="cpu").run(X, y, **grid)
    assert _rel(auto.objectives, ref.objectives) < 1e-6
    assert int(auto.kept[1:].sum()) <= int(ref.kept[1:].sum())
    assert len(rule.telemetry) == len(auto.lambdas) - 1
    assert rule._solve_per_feat is not None and rule._solve_per_feat > 0
    probes = [t for t in rule.telemetry if t["extra_swept"]]
    assert probes and all(t["sweep_s"] > 0 and t["extra_screened"] >= 0 for t in probes)
    tele = auto.extras["rule_telemetry"]
    assert len(tele) == len(auto.lambdas)
    assert all("auto" in t for t in tele[1:])
    assert all(t["auto"]["kept"] == int(k) for t, k in zip(tele[1:], auto.kept[1:]))
    # the reference's rule on the same path: the same probe schedule
    ref_rule = RefAutoRule(probe_every=2)
    RefDriver([ref_rule], L=L).run(X, y, **grid)
    assert ([t["extra_swept"] for t in rule.telemetry]
            == [t["extra_swept"] for t in ref_rule.telemetry])
    # prepare() forgets the anchor and the telemetry
    rule.prepare(torch.from_numpy(X), torch.from_numpy(y))
    assert rule._anchor is None and rule.telemetry == []


# -- sifs: EDPP features + verified samples, both reductions -----------------

@pytest.fixture(scope="module")
def bench():
    ds = make_sparse_classification(m=2000, n=400, seed=11)
    return ds, float(lipschitz_estimate(torch.from_numpy(ds.X)))


@pytest.mark.parametrize("reduce", ["gather", "mask"])
def test_sifs_path_matches_reference_and_certifies_samples(bench, reduce):
    """The bench instance on the deep grid at 2000 fixed iterations a step
    (where the composite path's card-vs-CPU spread is 3.2e-7): objectives
    rel 1e-6 against the reference's ``sifs`` path; samples screen, and
    every screened sample has zero slack in float64."""
    ds, L = bench
    kw = dict(rules="sifs", reduce=reduce, L=L, tol=-1.0, max_iters=2000)
    ref = RefDriver(**kw).run(ds.X, ds.y, **DEEP)
    port = PathDriver(device="cpu", **kw).run(ds.X, ds.y, **DEEP)
    assert _rel(port.objectives, ref.objectives) <= 1e-6
    assert port.rules == ("edpp", "sample_vi") == tuple(ref.rules)
    assert np.any(port.kept_samples[1:] < ds.X.shape[1])
    assert port.kept[1] < ds.X.shape[0]
    for k, mask in port.extras["sample_masks"].items():
        if (~mask).any():
            assert _xi64(ds.X, ds.y, port.weights[k], port.biases[k])[~mask].max() <= 1e-6


# -- dynamic screening with the new rules ------------------------------------

@pytest.mark.parametrize("rules", ["edpp", "auto"])
def test_dynamic_feature_rule_path_matches_reference(feature_paths, rules):
    """``dynamic=True``: the in-solver refresh is the at-lambda VI region
    whatever the rule; 300 fixed iterations a step, rel 1e-6 against the
    reference's dynamic path, and no feature of the unscreened path is
    dropped inside a solve."""
    p = feature_paths
    kw = dict(L=p["L"], dynamic=True, screen_every=25, **FIXED_300)
    port = PathDriver(rules, device="cpu", **kw).run(p["X"], p["y"], **FEATURE_GRID)
    ref = RefDriver(rules, **kw).run(p["X"], p["y"], **FEATURE_GRID)
    assert _rel(port.objectives, ref.objectives) <= 1e-6
    live = port.extras["dynamic_keep_masks"]
    for k in range(1, len(port.lambdas)):
        assert np.all(live[k][_support(p["unscreened"].weights[k])]), k
    assert any(d["kept_per_segment"][-1] < port.kept[k]
               for k, d in port.extras["dynamic"].items() if k >= 1)


def test_dynamic_sifs_mask_path_matches_reference(bench):
    """``sifs`` in mask mode with the in-solver sample re-screen, at 2000
    fixed iterations a step: rel 1e-6 against the reference, and every
    screened sample (the rule's and the solver's) at zero slack."""
    ds, L = bench
    kw = dict(rules="sifs", reduce="mask", L=L, tol=-1.0, max_iters=2000,
              dynamic=True, screen_every=25)
    ref = RefDriver(**kw).run(ds.X, ds.y, **DEEP)
    port = PathDriver(device="cpu", **kw).run(ds.X, ds.y, **DEEP)
    assert _rel(port.objectives, ref.objectives) <= 1e-6
    assert any("kept_samples_per_segment" in d for d in port.extras["dynamic"].values())
    for k, mask in port.extras["sample_masks"].items():
        if (~mask).any():
            assert _xi64(ds.X, ds.y, port.weights[k], port.biases[k])[~mask].max() <= 1e-6


# -- the entry point and the launcher ----------------------------------------

def test_svm_path_takes_the_new_rules():
    X, y = _problem(m=120, n=60, seed=3, planted=4)
    for rules in ("edpp", "auto", "sifs"):
        res = svm_path(X, y, rules=rules, n_lambdas=4, device="cpu")
        assert np.all(np.isfinite(res.objectives))
        assert res.rules == tuple(r.name for r in make_rules(rules))


@pytest.mark.parametrize("rules", ["edpp", "auto", "sifs"])
def test_launcher_new_rules(capsys, rules, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the launcher writes artifacts/ here
    assert train_main(["--m", "300", "--n", "120", "--rules", rules,
                       "--lam-min-ratio", "0.02", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"rules={rules}" in out
    assert len([ln for ln in out.splitlines() if ln.startswith("step")]) == 8
