"""K-fold cross-validation splits and the order a run solves them in.

Round ``r`` permutes the ``n`` samples with a generator seeded by
``(split_seed, r)``; its ``k`` test folds are consecutive slices of ``n //
k`` samples, and the ``n % k`` samples past the last slice stay in every
training fold of that round. So every training fold has ``n - n // k``
samples, one shape for the whole run, and no two rounds split alike. Round
``-1`` is the warm-up's.

A run solves a pool: the ``k`` folds of each of the traffic's
``pool_rounds`` rounds, in cycles, each cycle the whole pool in an order
drawn from the run's seed and the cycle's index. Every seed solves the
same paths, so a rate is not a draw of how many slow paths a window
caught (a path's cost depends on its fold, and one step in some tens runs
the solver to its iteration cap), and the seed orders them. The seed also
draws one fold of a round of its own (:func:`fresh_fold`), which a run
solves once its window has closed, for the check alone.
"""

from __future__ import annotations

import numpy as np
import torch


def train_size(n: int, k: int) -> int:
    return n - n // k


def train_columns(n: int, k: int, seed: int, round_: int, fold: int) -> np.ndarray:
    """The sorted sample indices of training fold ``fold`` of round ``round_``."""
    if not 0 <= fold < k:
        raise ValueError(f"fold {fold} outside [0, {k})")
    ss = np.random.SeedSequence([int(seed) % (2 ** 64), int(round_) % (2 ** 64)])
    perm = np.random.default_rng(ss).permutation(n)
    t = n // k
    test = np.zeros(n, bool)
    test[perm[fold * t:(fold + 1) * t]] = True
    return np.nonzero(~test)[0]


def pool(rounds: int, k: int) -> list[tuple[int, int]]:
    """The ``(round, fold)`` of every path of the pool."""
    return [(r, f) for r in range(rounds) for f in range(k)]


#: the first round of the folds the seeds draw, past any pool's rounds
FRESH_ROUND0 = 2 ** 32


def fresh_fold(seed: int, k: int) -> tuple[int, int]:
    """The ``(round, fold)`` that the run seeded ``seed`` checks besides its
    pool."""
    return FRESH_ROUND0 + int(seed) % FRESH_ROUND0, int(seed) % k


def cycle_order(jobs: list, seed: int, cycle: int) -> list:
    """``jobs`` in the order of cycle ``cycle`` of the run seeded ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (2 ** 64), int(cycle)])
    return [jobs[i] for i in np.random.default_rng(ss).permutation(len(jobs))]


class FoldFeed:
    """One training fold's ``(X, y)`` on X's device, in buffers allocated
    once, so every path of a run sees the same addresses and shapes."""

    def __init__(self, X: torch.Tensor, y: torch.Tensor, k: int, split_seed: int):
        self.X, self.y, self.k, self.seed = X, y, k, split_seed
        m, n = X.shape
        nt = train_size(n, k)
        self.Xf = torch.empty((m, nt), dtype=X.dtype, device=X.device)
        self.yf = torch.empty((nt,), dtype=y.dtype, device=y.device)

    def columns(self, round_: int, fold: int) -> np.ndarray:
        return train_columns(self.X.shape[1], self.k, self.seed, round_, fold)

    def load(self, round_: int, fold: int):
        """Gathers the fold's columns into the buffers; returns them."""
        idx = torch.as_tensor(self.columns(round_, fold), device=self.X.device)
        torch.index_select(self.X, 1, idx, out=self.Xf)
        torch.index_select(self.y, 0, idx, out=self.yf)
        return self.Xf, self.yf
