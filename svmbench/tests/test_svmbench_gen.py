"""The data generator at the published shapes and the cross-validation
splits: shapes and nonzeros a sample, the same bits from the same seed,
folds that are disjoint and cover every sample. The full-size data is made
on the card only (``gpu``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from svmbench.gen import text_like
from svmbench.harness import cv

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = {c: json.loads((BENCH / "configs" / f"{c}.json").read_text())
           for c in ("rcv1_binary", "real_sim")}
PUBLISHED = {"rcv1_binary": (47236, 20242, 1498952),
             "real_sim": (20958, 72309, 3709083)}
SMALL = {"features": 2000, "samples": 400, "nnz_per_sample": 30}


def small(name):
    cfg = dict(CONFIGS[name], **SMALL)
    cfg["assumed"] = dict(cfg["assumed"], head=200)
    return cfg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_state_the_published_shapes(name):
    m, n, nnz = PUBLISHED[name]
    cfg = CONFIGS[name]
    assert (cfg["features"], cfg["samples"]) == (m, n)
    assert abs(cfg["nnz_per_sample"] * n - nnz) / nnz < 1e-3
    assert cfg["reduced"] == [] and cfg["dtype"] == "float32"
    p = text_like.zipf_frequencies(m, n, cfg["nnz_per_sample"] * n)
    assert abs(p.sum() * n / nnz - 1.0) < 1e-3
    assert np.all(np.diff(p) <= 0) and p.max() <= 1.0 and p.min() > 0.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_small_shape_on_the_cpu(name):
    X, y = text_like.make(small(name), 2 ** 31 + 5, "cpu")
    assert X.shape == (2000, 400) and X.dtype == torch.float32 and y.shape == (400,)
    per_sample = float((X != 0).sum()) / 400
    assert abs(per_sample / 30 - 1.0) < 0.05
    assert set(torch.unique(y).tolist()) == {-1.0, 1.0}
    assert abs(float(y.mean())) <= 0.01
    assert torch.isfinite(X).all()


def test_same_seed_same_bits():
    cfg = small("rcv1_binary")
    a = text_like.make(cfg, 2 ** 33 + 1, "cpu")
    b = text_like.make(cfg, 2 ** 33 + 1, "cpu")
    c = text_like.make(cfg, 2 ** 33 + 2, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("n,k", [(400, 5), (20242, 5), (72309, 5), (17, 3)])
def test_folds_disjoint_and_covering(n, k):
    seed = 2 ** 32 + 3
    tests = []
    for f in range(k):
        tr = cv.train_columns(n, k, seed, 4, f)
        assert len(tr) == cv.train_size(n, k) and np.all(np.diff(tr) > 0)
        test = np.setdiff1d(np.arange(n), tr)
        assert len(test) == n // k
        tests.append(test)
    allt = np.concatenate(tests)
    assert len(np.unique(allt)) == len(allt)  # disjoint
    # the n % k samples no test fold holds are in every training fold
    rest = np.setdiff1d(np.arange(n), allt)
    assert len(rest) == n % k
    assert np.array_equal(cv.train_columns(n, k, seed, 4, 0),
                          cv.train_columns(n, k, seed, 4, 0))
    assert not np.array_equal(cv.train_columns(n, k, seed, 4, 0),
                              cv.train_columns(n, k, seed, 5, 0))


def test_fold_feed_keeps_one_buffer():
    X, y = text_like.make(small("real_sim"), 7, "cpu")
    feed = cv.FoldFeed(X, y, 5, 7)
    ptr = feed.Xf.data_ptr()
    for r, f in [(0, 0), (0, 3), (2, 1)]:
        Xf, yf = feed.load(r, f)
        idx = feed.columns(r, f)
        assert Xf.data_ptr() == ptr
        assert torch.equal(Xf, X[:, idx]) and torch.equal(yf, y[idx])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_published_shape_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the full-size data is made on the card")
    m, n, nnz = PUBLISHED[name]
    X, y = text_like.make(CONFIGS[name], 2 ** 31 + 5, "cuda")
    assert X.shape == (m, n) and X.is_cuda
    assert abs(float((X != 0).sum()) / nnz - 1.0) < 0.01
    X2, _ = text_like.make(CONFIGS[name], 2 ** 31 + 5, "cuda")
    assert torch.equal(X, X2)


def test_every_seed_solves_the_same_pool_in_its_own_order():
    jobs = cv.pool(2, 5)
    assert jobs == [(r, f) for r in range(2) for f in range(5)]
    a = cv.cycle_order(jobs, 2 ** 40 + 1, 0)
    assert sorted(a) == jobs
    assert a == cv.cycle_order(jobs, 2 ** 40 + 1, 0)
    orders = {tuple(cv.cycle_order(jobs, s, c)) for s in range(4) for c in range(3)}
    assert len(orders) > 6 and all(sorted(o) == jobs for o in orders)


def test_each_seed_draws_a_fold_outside_the_pool():
    n, k = 1000, 5
    pool = {tuple(cv.train_columns(n, k, 0, r, f)) for r, f in cv.pool(3, k)}
    fresh = [cv.fresh_fold(s, k) for s in (0, 1, 2 ** 31 + 9, 2 ** 40 + 3)]
    assert all(r >= cv.FRESH_ROUND0 and 0 <= f < k for r, f in fresh)
    assert fresh[0] == cv.fresh_fold(0, k)
    cols = [tuple(cv.train_columns(n, k, 0, r, f)) for r, f in fresh]
    assert len(set(cols)) == len(cols) and not set(cols) & pool
