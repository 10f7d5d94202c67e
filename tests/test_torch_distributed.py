"""The port's sharded lanes (``core/distributed.py``, the seam of
``core/solver.py``, ``path_scan.svm_path_scan_sharded``, the launcher's
``--model/--data``) on CPU ranks (gloo), against the port's single-device
functions and against the reference.

Inputs: ``make_sparse_classification(m=128, n=64, seed=51)`` made with
numpy. Each grid (2 x 2, 4 x 1, 1 x 4) is one spawn of its ranks, which run
every sharded function once (``_torch_dist_ranks.suite``) and return whole
vectors; the 1 x 1 grid runs in this process. The reference's sharded
functions run once, in one subprocess with 8 host devices
(``_torch_dist_reference.py``). FISTA and the paths run at fixed iterations
(``tol = -1``) on the port's L. Tolerances:

* 1 x 1: bit for bit the single-device functions (the seam is the
  identity);
* the feature screen on 4 x 1 (model only) and the sample sweep on 1 x 4
  (data only): bit for bit the single-device kernel's plain version (a row's
  or a column's sums do not depend on the split), as the reference claims;
* every other grid: bounds within rtol/atol 2e-4 (the reference's own
  test), the sample surplus within 1e-5 relative to its scale, fixed-iteration
  objectives within rel 1e-6, a solve's weights within 1e-4 (as in
  ``test_torch_path_scan.py``), a path's within 1e-3 (40 iterations a step
  leave it mid-solve, where a coordinate that enters the support an
  iteration apart differs by up to 1.3e-4);
* the launcher's host lane (``PathDriver(grid=..., reduce="mask")``)
  against ``PathDriver(reduce="mask")`` on one device: objectives within
  rel 1e-6 (composite on 2 x 2; ``edpp`` and ``dvi`` on 4 x 1, 2 x 2 and
  1 x 4; ``auto`` and ``--exact-lipschitz`` on 2 x 2; ``--dynamic`` with
  ``feature_vi`` on 2 x 2), step 1's keep mask equal; ``auto``'s decisions
  the same on every rank;
* the reference: screen bounds within 2e-4, sharded objectives within rel
  1e-5 (its body has no guard; its dynamic certificate runs the same 4
  rounds), and the dynamic solve's screened features safe: none is nonzero
  in the unscreened solution;
* safety exact.
"""

import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_ranks import suite
from repro.core import path_scan as ref_scan
from repro.core.dual import bias_at_lambda_max as ref_bias
from repro.core.dual import lambda_max as ref_lambda_max
from repro.core.dual import theta_at_lambda_max as ref_theta_max
from repro.core.screening import screen as ref_screen
from repro.core.solver import fista_solve as ref_fista_solve
from repro_torch.core import distributed as D
from repro_torch.core.dual import lambda_max, safe_theta_and_delta, theta_at_lambda_max
from repro_torch.core.path import PathDriver
from repro_torch.core.path_scan import svm_path_scan, svm_path_scan_sharded
from repro_torch.core.screening import shared_scalars
from repro_torch.core.solver import (
    fista_run,
    fista_run_dynamic,
    fista_solve,
    lipschitz_estimate,
)
from repro_torch.core.rules import FeatureVIRule
from repro_torch.data import make_sparse_classification
from repro_torch.kernels.screen import sample_surplus_plain, screen_bounds_plain
from repro_torch.sparse import FeatureChunked
from repro_torch.launch.train_svm import main as train_main

ROOT = Path(__file__).resolve().parents[1]
GRIDS = [(2, 2), (4, 1), (1, 4)]
ALL_GRIDS = [(1, 1)] + GRIDS
ITERS, SCREEN_EVERY = 60, 20
RULES = ["feature_vi", "edpp", "dvi"]
PATH = dict(n_lambdas=5, lam_min_ratio=0.15, max_iters=40, tol=-1.0)
#: the host lane's cases, by grid: composite on the deep grid (samples are
#: screened there), the feature rules and the in-solver re-screen on a
#: shallow one (features are screened there)
DEEP = dict(n_lambdas=6, lam_min_ratio=0.02, max_iters=40, tol=-1.0)
SHALLOW = dict(n_lambdas=6, lam_min_ratio=0.3, max_iters=40, tol=-1.0)
HOST_LANES = {
    (2, 2): {"composite": dict(rules="composite", **DEEP),
             "dynamic": dict(rules="feature_vi", dynamic=True,
                             screen_every=SCREEN_EVERY, **SHALLOW),
             "edpp_2x2": dict(rules="edpp", **SHALLOW),
             "dvi_2x2": dict(rules="dvi", **SHALLOW),
             "auto_2x2": dict(rules="auto", **SHALLOW),
             "exact_lipschitz_2x2": dict(rules="feature_vi", exact_lipschitz=True,
                                         **SHALLOW)},
    (4, 1): {"edpp": dict(rules="edpp", **SHALLOW), "dvi": dict(rules="dvi", **SHALLOW)},
    (1, 4): {"edpp_1x4": dict(rules="edpp", **SHALLOW),
             "dvi_1x4": dict(rules="dvi", **SHALLOW)},
}
SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return make_sparse_classification(m=128, n=64, seed=51)


@pytest.fixture(scope="module")
def cfg(ds):
    """The inputs every grid shares: the port's L, an inexact anchor solved
    on one device, a primal point for the sample sweep, masks."""
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    lmax = float(lambda_max(X, y))
    lam1 = 0.5 * lmax
    res1 = fista_solve(X, y, lam1, max_iters=6000, tol=1e-12)
    theta_s, delta_s = safe_theta_and_delta(X, y, res1.w, res1.b, lam1)
    rng = np.random.default_rng(7)
    m, n = ds.X.shape
    return dict(
        L=float(lipschitz_estimate(X)), lam2=0.4 * lmax, lam1=lam1, lam2b=0.9 * lam1,
        theta_s=theta_s.numpy(), delta_s=float(delta_s), w1=res1.w.numpy(),
        b1=float(res1.b), dw=0.37, db=0.05,
        u_prev=rng.standard_normal(n).astype(np.float32),
        sm=(rng.random(n) < 0.7).astype(np.float32),
        fm=(rng.random(m) < 0.6).astype(np.float32),
        iters=ITERS, screen_every=SCREEN_EVERY, rules=RULES, path=PATH)


@pytest.fixture(scope="module")
def reference_run(ds, cfg, tmp_path_factory):
    """Starts the reference's subprocess (8 host devices); :func:`reference`
    reads what it wrote. It runs while the grids' ranks run."""
    tmp = tmp_path_factory.mktemp("ref_sharded")
    lmax = float(ref_lambda_max(jnp.asarray(ds.X), jnp.asarray(ds.y)))
    lambdas = lmax * np.geomspace(1.0, PATH["lam_min_ratio"], PATH["n_lambdas"])
    np.savez(tmp / "in.npz", X=ds.X, y=ds.y, lambdas=lambdas,
             path_iters=PATH["max_iters"],
             **{k: v for k, v in cfg.items() if k not in ("rules", "path")})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_reference.py"),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, tmp / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate(timeout=30)


@pytest.fixture(scope="module")
def grids(ds, cfg, reference_run):
    """Every rank's answers, by grid: one spawn a grid; 1 x 1 in process."""
    arrays = {"X": ds.X, "y": ds.y}
    out = {(1, 1): [suite(D.svm_grid(1, 1), arrays, cfg)]}
    for M, Dd in GRIDS:
        c = dict(cfg, host_lanes=HOST_LANES.get((M, Dd), {}))
        out[(M, Dd)] = D.run_grid(suite, M, Dd, arrays, (c,), device="cpu",
                                   timeout=SPAWN_TIMEOUT)
    return out


@pytest.fixture(scope="module")
def single(ds, cfg):
    """The port's single-device answers."""
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    lmax = lambda_max(X, y)
    theta0 = theta_at_lambda_max(y, lmax)
    inv_L = 1.0 / torch.clamp_min(torch.tensor(cfg["L"], dtype=torch.float32) * 1.01,
                                  1e-12)
    lam2 = cfg["lam2"]
    w0, b0 = torch.zeros(X.shape[0]), torch.mean(y)
    out = {
        "lam_max": float(lmax),
        "bounds0": screen_bounds_plain(X, y, theta0,
                                       shared_scalars(y, lmax, 0.4 * lmax, theta0)),
        "bounds_s": screen_bounds_plain(
            X, y, torch.from_numpy(cfg["theta_s"]),
            shared_scalars(y, cfg["lam1"], cfg["lam2b"], torch.from_numpy(cfg["theta_s"]),
                           delta=cfg["delta_s"])),
    }
    out["surplus"], out["u1"] = sample_surplus_plain(
        X, torch.from_numpy(cfg["w1"]), y, cfg["b1"], cfg["dw"], cfg["db"],
        torch.from_numpy(cfg["u_prev"]))
    fm, sm = torch.from_numpy(cfg["fm"]), torch.from_numpy(cfg["sm"])
    out["static"] = fista_run(X, y, lam2, w0, b0, inv_L, max_iters=ITERS, tol=-1.0)
    out["masked"] = fista_run(X, y, lam2, w0, b0, inv_L, sm, fm, max_iters=ITERS,
                              tol=-1.0)
    out["dynamic"] = fista_run_dynamic(X, y, lam2, w0, b0, inv_L, None, torch.ones(
        X.shape[0]), ITERS, -1.0, SCREEN_EVERY)
    out["paths"] = {r: svm_path_scan(ds.X, ds.y, rules=r, L=cfg["L"], device="cpu",
                                     **PATH) for r in RULES}
    out["unscreened"] = fista_solve(X, y, lam2, max_iters=20000, tol=1e-12)
    out["host_lanes"] = {}
    for lanes in HOST_LANES.values():
        for name, kw in lanes.items():
            kw = dict(kw)
            grid = {k: kw.pop(k) for k in ("n_lambdas", "lam_min_ratio")}
            if not kw.get("exact_lipschitz"):
                kw["L"] = cfg["L"]
            out["host_lanes"][name] = PathDriver(reduce="mask", device="cpu",
                                                 **kw).run(ds.X, ds.y, **grid)
    out["shallow_unscreened"] = svm_path_scan(
        ds.X, ds.y, screening=False, L=cfg["L"], device="cpu",
        **dict(SHALLOW, max_iters=20000, tol=1e-12))
    return out


@pytest.fixture(scope="module")
def reference(reference_run):
    """The reference's sharded functions: what its subprocess wrote."""
    proc, out = reference_run
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-4000:]
    return dict(np.load(out))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        for x, z in zip(a, b):
            _same(x, z)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _ranks_agree(results, key):
    """Every rank's answer to ``key``, which must be the same bits."""
    for r in results[1:]:
        _same(results[0][key], r[key])
    return results[0][key]


# -- the screen ------------------------------------------------------------------


@pytest.mark.parametrize("grid", ALL_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("anchor", ["closed_form", "inexact"])
def test_screen_sharded_matches_single_device(grids, single, reference, grid, anchor):
    """Bounds of every rank alike; bit for bit on 1 x 1 and model-only
    grids, within 2e-4 elsewhere; the keep masks of a model-only grid
    bit for bit (the reference's claim); within 2e-4 of the reference's
    sharded screen on the same mesh."""
    key = "bounds0" if anchor == "closed_form" else "bounds_s"
    got = _ranks_agree(grids[grid], key)
    want = single[key].numpy()
    if grid[1] == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    if grid != (1, 1):
        tag = f"{grid[0]}x{grid[1]}"
        np.testing.assert_allclose(got, reference[f"{key}_{tag}"], rtol=2e-4, atol=2e-4)


def test_screen_sharded_against_reference_local(ds, grids):
    """The closed-form anchor's screen against the reference's local
    ``screen``: every feature it keeps, every grid keeps (safety), and the
    bounds within 2e-4."""
    X, y = jnp.asarray(ds.X), jnp.asarray(ds.y)
    lmax = ref_lambda_max(X, y)
    keep, bounds = ref_screen(X, y, lmax, 0.4 * lmax, ref_theta_max(y, lmax))
    for grid in ALL_GRIDS:
        r = grids[grid][0]
        np.testing.assert_allclose(r["bounds0"], np.asarray(bounds), rtol=2e-4, atol=2e-4)
        assert not np.any(np.asarray(keep) & ~r["keep0"]), grid


def test_lambda_max_and_lipschitz_sharded(grids, single, cfg):
    for grid in ALL_GRIDS:
        r = grids[grid][0]
        assert abs(r["lam_max"] - single["lam_max"]) <= 1e-6 * single["lam_max"], grid
        assert abs(r["L"] - cfg["L"]) <= 1e-5 * cfg["L"], grid
    assert grids[(1, 1)][0]["L"] == cfg["L"]


# -- the sample sweep --------------------------------------------------------------


@pytest.mark.parametrize("grid", ALL_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_sample_surplus_sharded_matches_single_device(grids, single, reference, grid):
    """Bit for bit where the feature axis is whole (the reference's
    contract), within 1e-5 of the scale elsewhere and of the reference."""
    got_s = _ranks_agree(grids[grid], "surplus")
    got_u = _ranks_agree(grids[grid], "u1")
    want_s, want_u = single["surplus"].numpy(), single["u1"].numpy()
    if grid[0] == 1:
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_u, want_u)
    else:
        assert _rel(got_u, want_u) <= 1e-5 and _rel(got_s, want_s) <= 1e-5
    if grid != (1, 1):
        tag = f"{grid[0]}x{grid[1]}"
        assert _rel(got_u, reference[f"u1_{tag}"]) <= 1e-5
        assert _rel(got_s, reference[f"surplus_{tag}"]) <= 1e-5


# -- FISTA -----------------------------------------------------------------------------


@pytest.mark.parametrize("grid", ALL_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("kind", ["static", "masked", "dynamic"])
def test_fista_sharded_matches_fista_run(grids, single, grid, kind):
    """``fista_sharded`` is ``fista_run`` / ``fista_run_dynamic`` with the
    grid's seam: the same fixed iterations, bit for bit on 1 x 1, the
    objective within rel 1e-6 and w within 1e-4 elsewhere."""
    got = _ranks_agree(grids[grid], kind)
    want = single[kind]
    assert got[3] == int(want.n_iters) == ITERS
    if grid == (1, 1):
        np.testing.assert_array_equal(got[0], want.w.numpy())
        assert got[2] == float(want.obj)
    else:
        assert abs(got[2] - float(want.obj)) <= 1e-6 * abs(float(want.obj))
        np.testing.assert_allclose(got[0], want.w.numpy(), atol=1e-4)


def test_fista_sharded_against_reference(ds, cfg, grids, single, reference):
    """Against the reference's ``fista_sharded`` on the 2 x 2 mesh (static
    and dynamic, fixed iterations, the same L) and its local
    ``fista_solve``: objectives within rel 1e-5; the dynamic solve's final
    mask drops no feature that the unscreened solution uses."""
    r = grids[(2, 2)][0]
    ref_local = ref_fista_solve(jnp.asarray(ds.X), jnp.asarray(ds.y), cfg["lam2"],
                                max_iters=ITERS, tol=-1.0, L=cfg["L"])
    for got, want in ((r["static"][2], reference["static_obj"]),
                      (r["static"][2], float(ref_local.obj)),
                      (r["dynamic"][2], reference["dynamic_obj"])):
        assert abs(got - want) <= 1e-5 * abs(want)
    support = np.abs(single["unscreened"].w.numpy()) > 1e-6
    for grid in ALL_GRIDS:
        fmask = grids[grid][0]["dynamic"][4]
        assert not np.any(support & ~fmask), grid
    assert not np.any(support & ~reference["dynamic_fmask"])


# -- the scan engine ------------------------------------------------------------------


@pytest.mark.parametrize("grid", ALL_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("rules", RULES)
def test_scan_sharded_matches_scan(grids, single, grid, rules):
    """``svm_path_scan_sharded`` against ``svm_path_scan`` (mask) at fixed
    iterations: bit for bit on 1 x 1 (objectives, weights, keep masks),
    objectives within rel 1e-6 and weights within 1e-3 elsewhere; every
    rank returns the same result."""
    got = _ranks_agree(grids[grid], "paths")[rules]
    want = single["paths"][rules]
    obj, w, kept, masks, engine, g = got
    assert engine == "scan_sharded" and g == {"model": grid[0], "data": grid[1]}
    if grid == (1, 1):
        np.testing.assert_array_equal(obj, want.objectives)
        np.testing.assert_array_equal(w, want.weights)
        np.testing.assert_array_equal(masks, want.extras["keep_masks"])
    else:
        assert _rel(obj, want.objectives) <= 1e-6
        # 40 iterations leave a step mid-solve: a coordinate entering the
        # support an iteration apart differs by up to 1.3e-4 (4 x 1)
        np.testing.assert_allclose(w, want.weights, atol=1e-3)
        # step 1 screens from the closed-form anchor: the same keeps
        assert kept[1] == want.kept[1]


def test_scan_sharded_against_reference(ds, cfg, grids, reference):
    """Against the reference's sharded scan program on the 2 x 2 mesh and
    its local one (same L, fixed iterations): objectives within rel 1e-5,
    step 1's kept count equal."""
    got = grids[(2, 2)][0]["paths"]["feature_vi"]
    assert _rel(got[0], reference["scan_obj"]) <= 1e-5
    assert got[2][1] == reference["scan_kept"][1]
    X, y = jnp.asarray(ds.X), jnp.asarray(ds.y)
    lmax = ref_lambda_max(X, y)
    lams = float(lmax) * np.geomspace(1.0, PATH["lam_min_ratio"], PATH["n_lambdas"])
    program = jax.jit(partial(
        ref_scan._path_scan_program, max_iters=PATH["max_iters"], screening=True,
        dynamic=False, screen_every=50, use_pallas=False, exact_lipschitz=False,
        reduce="mask", rules=("feature_vi",)))
    out = program(X, y, jnp.asarray(lams, jnp.float32), jnp.zeros(X.shape[0]),
                  ref_bias(y), ref_theta_max(y, lmax), jnp.asarray(0.0), lmax,
                  jnp.asarray(cfg["L"], jnp.float32), 1.0 - 2e-3, -1.0)
    assert _rel(got[0], np.asarray(out.obj)) <= 1e-5


def test_scan_sharded_is_safe(ds, grids, cfg):
    """No feature that the unscreened path makes nonzero is screened, on any
    grid and rule."""
    full = svm_path_scan(ds.X, ds.y, screening=False, L=cfg["L"], device="cpu", **PATH)
    support = np.abs(full.weights) > 1e-6
    for grid in ALL_GRIDS:
        for rules, got in grids[grid][0]["paths"].items():
            assert not np.any(support & ~got[3]), (grid, rules)


# -- the host lane ---------------------------------------------------------------------


def test_host_lane_matches_svm_path(grids, single, ds):
    """The launcher's sharded host lane (composite, mask, verified samples)
    on the 2 x 2 grid against ``svm_path(rules="composite",
    reduce="mask")`` at fixed iterations: objectives within rel 1e-6, and
    every screened sample has zero slack in float64 at the accepted
    solution."""
    obj, _, kept_s, w, b, *_ = _ranks_agree(grids[(2, 2)], "host_lanes")["composite"]
    want = single["host_lanes"]["composite"]
    assert _rel(obj, want.objectives) <= 1e-6
    assert kept_s.min() < ds.X.shape[1]  # samples were screened
    np.testing.assert_array_equal(kept_s, want.kept_samples)
    margins = ds.y[None, :] * (w @ ds.X.astype(np.float64) + b[:, None])
    screened = np.zeros_like(margins, dtype=bool)
    for k, mask in want.extras["sample_masks"].items():
        screened[k] = ~mask
    assert not np.any(screened & (margins < 1.0 - 1e-6))


@pytest.mark.parametrize("name,grid", [
    ("edpp", (4, 1)), ("dvi", (4, 1)), ("dynamic", (2, 2)),
    ("edpp_2x2", (2, 2)), ("dvi_2x2", (2, 2)), ("edpp_1x4", (1, 4)),
    ("dvi_1x4", (1, 4)), ("auto_2x2", (2, 2)), ("exact_lipschitz_2x2", (2, 2))])
def test_host_lane_feature_screens_match_path_driver(grids, single, name, grid):
    """The host lane's other feature screens (``PathDriver(grid=...)``)
    against ``PathDriver(reduce="mask")`` on one device at fixed
    iterations: ``edpp`` and ``dvi`` along the seam (the scan lane's
    ``_stack_bounds``: a full launch on a model-only grid, the partial mode
    and the finalize where samples are split), ``auto`` with rank 0's
    policy, ``--exact-lipschitz`` (L estimated in every solve, sharded) and
    the in-solver re-screen (``--dynamic``, ``fista_sharded(screen_every=)``)
    on 2 x 2. Objectives within rel 1e-6; step 1 (the closed-form anchor)
    keeps the same features; features are screened, and none that the
    unscreened path uses; ``auto``'s decisions are the same on every rank.
    Later steps may keep more than ``PathDriver``: the lane certifies its
    anchors with ``gap_theta_delta``, ``PathDriver`` with the tighter
    ``safe_theta_and_delta``."""
    lanes = [r["host_lanes"][name] for r in grids[grid]]
    obj, kept, _, _, _, masks, dyn, dyn_masks, decisions = _ranks_agree(
        grids[grid], "host_lanes")[name]
    want = single["host_lanes"][name]
    assert _rel(obj, want.objectives) <= 1e-6
    np.testing.assert_array_equal(masks[1:].sum(1), kept[1:])
    np.testing.assert_array_equal(masks[1], want.extras["keep_masks"][1])
    if name == "dynamic":
        assert dyn.keys() == want.extras["dynamic"].keys()
        masks = dyn_masks
    assert masks[1:].sum() < masks[1:].size  # features were screened
    support = np.abs(single["shallow_unscreened"].weights) > 1e-6
    assert not np.any(support & ~masks)
    if name.startswith("auto"):
        assert all(lane[8] == decisions for lane in lanes)
        assert any(swept for swept, _, _ in decisions)  # a probe ran the sweep


# -- what a grid rejects ------------------------------------------------------------------


def test_rejected_configurations(ds, tmp_path, monkeypatch):
    """Uneven splits, the dynamic sharded scan, compact reduction, chunked
    storage (the reference's own rejections), a gather on a grid and a rule
    with no sharded route raise; ``auto`` and ``edpp`` over a split sample
    axis are accepted."""
    monkeypatch.chdir(tmp_path)
    g = D.SvmGrid(model=2, data=2, rank=3)
    with pytest.raises(ValueError, match="split evenly"):
        g.rows(129)
    with pytest.raises(ValueError, match="split evenly"):
        g.block(np.zeros((128, 63)))
    with pytest.raises(ValueError, match="dynamic"):
        svm_path_scan_sharded(D.svm_grid(1, 1), ds.X, ds.y, dynamic=True, device="cpu")
    with pytest.raises(ValueError, match="mask"):
        PathDriver(grid=g, device="cpu")
    for rules in ("auto", "edpp"):
        PathDriver(rules, grid=g, reduce="mask", device="cpu")

    class NoProgram(FeatureVIRule):
        program = None

    with pytest.raises(ValueError, match="no sharded route"):
        PathDriver(NoProgram(), grid=g, reduce="mask", device="cpu").run(
            ds.X[:64, :32], ds.y[:32])
    with pytest.raises(ValueError, match="chunk"):
        PathDriver(grid=g, reduce="mask", device="cpu").run(
            FeatureChunked.from_dense(ds.X[:64, :32], chunk_m=16), ds.y[:32])
    for argv, what in ((["--engine", "scan", "--reduce", "compact"], "compact"),
                       (["--engine", "scan", "--dynamic"], "dynamic"),
                       (["--storage", "chunked"], "storage"),
                       (["--engine", "batched"], "batched")):
        with pytest.raises(SystemExit):
            train_main(["--m", "64", "--n", "32", "--model", "2", "--data", "2",
                        "--device", "cpu", *argv])


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is there")
def test_run_grid_defaults_to_the_card_and_raises_without_one(tmp_path):
    """``run_grid`` runs its ranks on the card unless ``device="cpu"`` is
    asked for, as every entry point does: without CUDA the default raises
    before any rank is spawned."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.run_grid(suite, 1, 1, {"x": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="is_available"):
        D.run_grid(suite, 2, 2, device="cuda")


@pytest.mark.parametrize("engine", ["host", "scan"])
def test_launcher_grid_lanes(engine, capsys, tmp_path, monkeypatch):
    """``--model 2 --data 2 --device cpu`` on both lanes: the ranks run the
    lane and report their all-reduces (in a directory of the test's own:
    the host lane checkpoints under it)."""
    monkeypatch.chdir(tmp_path)
    rc = train_main(["--m", "64", "--n", "32", "--n-lambdas", "4",
                     "--model", "2", "--data", "2", "--device", "cpu",
                     "--engine", engine, "--rules",
                     "composite" if engine == "host" else "feature_vi"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "grid=2x2 backend=gloo" in out
    assert out.count("step ") == 4 and out.count("allreduce_calls=") == 4
