"""Verified sample screening in the port (``sample_vi``, ``composite``, the
sample-axis gather and ``reduce="mask"``) against the reference.

Bench instance: m=2000, n=400, seed 11, 8 lambdas, lam_min_ratio 0.02 (a
deep grid: the sample rule screens from step 5). Both packages get the same
L. Tolerances:

* composite path vs the port's unscreened path: weights and biases atol
  3e-3, as the reference's own ``tests/test_rules.py`` holds its composite
  path;
* composite path vs the reference's composite path: objectives rel 1e-5
  (the reference's host-vs-scan spread is 7.9e-6);
* the sample rule on the reference's own regions: surpluses rtol 1e-5 with
  an absolute floor of 1e-5 of their scale, wherever the slack is below
  1e29 (the kernel clamps the total slack at 1e30, the reference ``dw`` and
  ``db`` one by one), and identical keep masks;
* zero false rejections: every screened sample has ``xi <= 1e-6`` at the
  accepted solution, in float64.

Kept counts are not compared step by step between the packages (ROADMAP
queue 3): the rule is held to the reference's on the reference's anchors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dual import theta_at_lambda_max as ref_theta_max
from repro.core.path import PathDriver as RefDriver
from repro.core.rules import ConvexRegion as RefRegion
from repro.core.rules import SampleVIRule as RefSampleRule
from repro.core.rules import make_rules as ref_make_rules
from repro.core.rules import sample_slack_caps as ref_slack_caps
from repro.core.rules.sample_vi import margin_surplus_core as ref_surplus_core
from repro.core.rules.sample_vi import violators_from_margins as ref_violators
from repro_torch.convert import path_arrays, state_from_numpy
from repro_torch.core.dual import theta_at_lambda_max
from repro_torch.core.path import PathDriver, svm_path
from repro_torch.core.rules import (
    AXIS_SAMPLES,
    CompositeRule,
    ConvexRegion,
    FeatureVIRule,
    SampleVIRule,
    ScreeningRule,
    make_rules,
    sample_slack_caps,
    solve_with_verification,
)
from repro_torch.core.rules.sample_vi import margin_surplus_core, violators_from_margins
from repro_torch.core.solver import lipschitz_estimate
from repro_torch.data import make_sparse_classification
from repro_torch.launch.train_svm import main as train_main

DEEP = dict(n_lambdas=8, lam_min_ratio=0.02)
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
def bench():
    ds = make_sparse_classification(m=2000, n=400, seed=11)
    L = float(lipschitz_estimate(torch.from_numpy(ds.X)))
    ref = {r: RefDriver("composite", L=L, reduce=r).run(ds.X, ds.y, **DEEP)
           for r in REDUCE}
    port = {r: PathDriver("composite", L=L, reduce=r, device="cpu").run(
        ds.X, ds.y, **DEEP) for r in REDUCE}
    unscreened = PathDriver([], L=L, device="cpu").run(ds.X, ds.y, **DEEP)
    return ds, L, ref, port, unscreened


def _xi64(ds, w, b):
    return np.maximum(0.0, 1.0 - ds.y.astype(np.float64)
                      * (ds.X.astype(np.float64).T @ w + b))


@pytest.mark.parametrize("reduce", REDUCE)
def test_composite_path_matches_unscreened_and_reference(bench, reduce):
    ds, _, ref, port, unscreened = bench
    p = port[reduce]
    np.testing.assert_allclose(p.weights, unscreened.weights, atol=3e-3)
    np.testing.assert_allclose(p.biases, unscreened.biases, atol=3e-3)
    r, pa = path_arrays(ref[reduce]), path_arrays(p)
    np.testing.assert_allclose(pa["lambdas"], r["lambdas"], rtol=1e-6)
    np.testing.assert_allclose(pa["objectives"], r["objectives"], rtol=1e-5)
    assert p.rules == ("feature_vi", "sample_vi")
    assert not np.any(p.extras["health"])
    # both axes screened somewhere on this grid
    assert p.kept[1] < ds.X.shape[0]
    assert np.any(p.kept_samples[1:] < ds.X.shape[1])
    assert set(p.extras["sample_masks"]) == set(range(1, len(p.lambdas)))


@pytest.mark.parametrize("reduce", REDUCE)
def test_screened_samples_have_zero_slack(bench, reduce):
    """Zero false rejections: at every step the accepted (w, b) has xi = 0
    on every screened sample (float64 recomputation), and the unscreened
    optimum agrees to solver tolerance."""
    ds, _, _, port, unscreened = bench
    p = port[reduce]
    screened_any = False
    for k, mask in p.extras["sample_masks"].items():
        assert mask.sum() == p.kept_samples[k]
        screened = ~mask
        if not screened.any():
            continue
        screened_any = True
        assert _xi64(ds, p.weights[k], p.biases[k])[screened].max() <= 1e-6, k
        xi_true = _xi64(ds, unscreened.weights[k], unscreened.biases[k])
        assert xi_true[screened].max() <= 1e-4, k
    assert screened_any, "no sample was screened on the deep grid"


def test_sample_rule_matches_reference_on_reference_regions(bench):
    """The reference path's accepted solutions as primal anchors, the trust
    radii as its driver computes them, and the reference rule's margin
    history handed to the port's rule (``convert``) before every call."""
    ds, _, ref, _, _ = bench
    r = ref["gather"]
    y = jnp.asarray(ds.y)
    st = state_from_numpy({"X": ds.X, "y": ds.y}, "cpu")
    theta_r = ref_theta_max(y, jnp.asarray(r.lambdas[0]))
    theta_p = theta_at_lambda_max(st["y"], float(r.lambdas[0]))
    rule_r, rule_p = RefSampleRule(), SampleVIRule()
    rule_r.prepare(jnp.asarray(ds.X), y)
    rule_p.prepare(st["X"], st["y"])
    screened = 0
    for k in range(2, len(r.lambdas)):
        w1, b1 = r.weights[k - 1].astype(np.float32), float(r.biases[k - 1])
        dw = 1.5 * float(np.linalg.norm(r.weights[k - 1] - r.weights[k - 2]))
        db = 1.5 * abs(r.biases[k - 1] - r.biases[k - 2])
        hist = {"w1": w1}
        if rule_r._u_prev is not None:
            hist["u_prev"] = np.asarray(rule_r._u_prev)
        a = state_from_numpy(hist, "cpu")
        rule_p._u_prev = a.get("u_prev")
        lam1, lam2 = r.lambdas[k - 1], r.lambdas[k]
        b_r = np.asarray(rule_r.bounds(jnp.asarray(ds.X), y, RefRegion.build(
            y, lam1, lam2, theta_r, w1=jnp.asarray(w1), b1=b1, dw=dw, db=db)),
            np.float64)
        keep_p, b_p = rule_p.screen(st["X"], st["y"], ConvexRegion.build(
            st["y"], lam1, lam2, theta_p, w1=a["w1"], b1=b1, dw=dw, db=db))
        b_p = b_p.double().numpy()
        live = np.abs(b_r) < 1e29
        np.testing.assert_allclose(b_p[live], b_r[live], rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(b_r[live]).max()))
        np.testing.assert_array_equal(keep_p.numpy(),
                                      np.asarray(rule_r.keep(jnp.asarray(b_r))))
        np.testing.assert_allclose(rule_p._u_prev.numpy(),
                                   np.asarray(rule_r._u_prev), rtol=1e-5, atol=1e-5)
        screened += int((~keep_p).sum())
    assert screened > 0


def test_sample_slack_caps_match_reference(bench):
    ds, _, ref, _, _ = bench
    r = ref["gather"]
    y = jnp.asarray(ds.y)
    st = state_from_numpy({"y": ds.y}, "cpu")
    rng = np.random.default_rng(0)
    theta = (np.asarray(ref_theta_max(y, jnp.asarray(r.lambdas[0])))
             + 0.01 * rng.random(400)).astype(np.float32)
    a = state_from_numpy({"theta": theta}, "cpu")
    lam1, lam2 = r.lambdas[2], r.lambdas[3]
    caps_r = np.asarray(ref_slack_caps(
        RefRegion.build(y, lam1, lam2, jnp.asarray(theta), delta=0.01)), np.float64)
    caps_p = sample_slack_caps(
        ConvexRegion.build(st["y"], lam1, lam2, a["theta"], delta=0.01))
    np.testing.assert_allclose(caps_p.double().numpy(), caps_r, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(caps_r).max()))


def test_margin_surplus_core_and_violators_match_reference():
    rng = np.random.default_rng(3)
    n = 257
    u1 = rng.standard_normal(n).astype(np.float32) * 2
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    x_sq = (rng.random(n) * 5).astype(np.float32)
    x_sq[0] = 0.0  # a zero column: no 0 * inf
    u_prev = rng.standard_normal(n).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(u1=u1, y=y, x_sq=x_sq, u_prev=u_prev).items()}
    for dw, db, hist in ((float("inf"), float("inf"), False),
                         (float("inf"), float("inf"), True), (0.3, 0.02, True)):
        got = margin_surplus_core(t["u1"], t["y"], t["x_sq"], dw, db,
                                  u_prev=t["u_prev"] if hist else None)
        want = np.asarray(ref_surplus_core(
            jnp.asarray(u1), jnp.asarray(y), jnp.asarray(x_sq), dw, db,
            u_prev=jnp.asarray(u_prev) if hist else None), np.float64)
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))
    idx = np.arange(0, n, 3)
    got = violators_from_margins(t["y"], t["u1"][idx], torch.from_numpy(idx))
    want = ref_violators(y, u1[idx], idx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_rules_flattens_composite_as_reference():
    rules = make_rules("composite")
    assert [r.name for r in rules] == [r.name for r in ref_make_rules("composite")]
    assert [r.axis for r in rules] == ["features", "samples"]
    assert isinstance(rules[1], SampleVIRule) and rules[1].needs_verification
    custom = make_rules(CompositeRule([FeatureVIRule(tau=0.9)]))
    assert len(custom) == 1 and custom[0].tau == 0.9
    assert make_rules(None) == []


class _Always(ScreeningRule):
    """A sample rule whose check always reports the first screened sample."""

    axis = AXIS_SAMPLES
    needs_verification = True

    def verify(self, X, y, w, b, screened_idx):
        return screened_idx[:1]


def test_verification_readmits_then_resets():
    """Each round re-admits the reported violators; at ``max_rounds`` the
    mask is reset to every sample and the loop ends."""
    X = torch.zeros((3, 6))
    y = torch.ones(6)
    masks = []

    def solve(mask):
        masks.append(mask.copy())
        return "res", torch.zeros(3), torch.tensor(0.0)

    s_mask = np.array([True, False, True, False, False, True])
    res, _, _, rounds = solve_with_verification(solve, [_Always()], X, y,
                                                s_mask, max_rounds=3)
    assert res == "res" and rounds == 3 and s_mask.all()
    assert [m.sum() for m in masks] == [3, 4, 5, 6]
    assert masks[1][1] and not masks[1][3]  # the first screened came back
    # no verifying rule: one solve, mask untouched
    s_mask = np.array([True, False])
    _, _, _, rounds = solve_with_verification(solve, [], X[:, :2], y[:2], s_mask)
    assert rounds == 0 and not s_mask[1]


def test_path_resets_when_verification_never_passes(bench):
    """A path whose sample check never passes ends each screened step on an
    exact solve over every sample: the objectives are the unscreened ones."""
    ds, L, _, _, unscreened = bench

    class NeverPasses(SampleVIRule):
        def verify(self, X, y, w, b, screened_idx):
            return screened_idx[:1]  # one at a time: the reset ends the loop

    res = PathDriver([NeverPasses()], L=L, max_verify_rounds=2,
                     device="cpu").run(ds.X, ds.y, **DEEP)
    screened_steps = res.verify_rounds > 0
    assert screened_steps.any()
    assert np.all(res.verify_rounds[screened_steps] == 2)
    assert np.all(res.kept_samples[1:] == 400)
    assert np.all(res.kept[1:] == 2000)  # a sample rule alone keeps features
    np.testing.assert_allclose(res.objectives, unscreened.objectives, rtol=1e-5)


def test_verification_readmits_on_a_deeper_instance():
    """4000 x 1000, seed 0: the margin prediction misses at the deepest
    steps and the verification loop re-admits samples there; the result
    stays exact."""
    ds = make_sparse_classification(m=4000, n=1000, seed=0)
    res = svm_path(ds.X, ds.y, rules="composite", device="cpu", **DEEP)
    assert res.verify_rounds.max() >= 1
    for k, mask in res.extras["sample_masks"].items():
        if (~mask).any():
            assert _xi64(ds, res.weights[k], res.biases[k])[~mask].max() <= 1e-6, k


def test_reduce_option_is_checked():
    with pytest.raises(ValueError, match="reduce"):
        PathDriver("composite", reduce="compact", device="cpu")


def test_launcher_composite_mask_on_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the launcher writes artifacts/ here
    assert train_main(["--m", "300", "--n", "120", "--rules", "composite",
                       "--reduce", "mask", "--n-lambdas", "8",
                       "--lam-min-ratio", "0.02", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    steps = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(steps) == 8
    assert all("kept_samples=" in ln and "verify_rounds=" in ln for ln in steps)
    assert "reduce=mask" in out
    kept_s = [int(ln.split("kept_samples=")[1].split()[0]) for ln in steps[1:]]
    assert min(kept_s) < 120


def test_state_from_numpy_takes_the_sample_rule_state():
    X = np.zeros((4, 3), np.float32)
    st = state_from_numpy({"X": X, "w1": np.zeros(4, np.float32),
                           "u_prev": np.ones(3, np.float32)}, "cpu")
    assert st["w1"].shape == (4,) and st["u_prev"].shape == (3,)
    with pytest.raises(ValueError, match="length"):
        state_from_numpy({"X": X, "u_prev": np.ones(4, np.float32)}, "cpu")
    with pytest.raises(ValueError, match="length"):
        state_from_numpy({"X": X, "w1": np.ones(3, np.float32)}, "cpu")
    with pytest.raises(ValueError, match="rank"):
        state_from_numpy({"u_prev": X}, "cpu")


def test_verify_tests_margins_in_float64():
    """Verification flags a screened sample whose float64 margin is below 1
    even where the fp32 margin reads 1, as the reference's float64 test does.

    Feature rows (1024, 1, 1) against w = (1, 1 - 2^-24, fl32(-4e-8)) and
    b = -1024: in fp32 every order of the sum gives u = 1025 and u + b = 1
    exactly, while in float64 the margin is 1 - 2^-24 - 4e-8 = 1 - 9.96e-8.
    Column 3 is the same case for the label -1 (u = 1023 in fp32, float64
    margin 1 - 9.96e-8). Columns 1 and 4 sit at 1 + 1e-4, column 2 at
    1 + 1.8e-7, in float64: none is flagged. (The float64 test lets the one
    just above 1 pass, as the reference does; flagging it would be safe,
    only looser.) Column 5 misses the margin by 1e-3."""
    w = np.array([1.0, 1.0 - 2.0 ** -24, -4e-8], np.float32)
    X = np.zeros((3, 6), np.float32)
    X[:, 0] = [1024.0, 1.0, 1.0]
    X[:, 1] = [1024.0, 1.0001, 0.0]
    X[:, 2] = [1024.0, np.float32(1 + 2 ** -23) / w[1], 0.0]
    X[:, 3] = [1024.0, -1.0, -1.0]
    X[:, 4] = [1024.0, -1.0001, 0.0]
    X[:, 5] = [1024.0, 0.999, 0.0]
    y = np.array([1, 1, 1, -1, -1, 1], np.float32)
    b = np.float32(-1024.0)
    margins = y * (X.astype(np.float64).T @ w.astype(np.float64) + float(b))
    assert np.all(np.abs(margins[[0, 3]] - (1 - 9.96e-8)) < 1e-10)
    assert 1 + 1e-7 < margins[2] < 1 + 1e-6
    assert margins[1] > 1 + 9e-5 and margins[4] > 1 + 9e-5
    Xt, wt, yt = torch.from_numpy(X), torch.from_numpy(w), torch.from_numpy(y)
    u32 = torch.mv(Xt.t(), wt) + b
    assert float(u32[0]) == 1.0 and float(u32[3]) == -1.0  # fp32: not below 1
    got = SampleVIRule().verify(Xt, yt, wt, torch.tensor(b), torch.arange(6))
    assert got.tolist() == [0, 3, 5]
    # only the screened samples are tested; b may be a number
    got = SampleVIRule().verify(Xt, yt, wt, float(b), torch.tensor([1, 2, 3]))
    assert got.tolist() == [3]
