"""Text-like two-class data at a LIBSVM dataset's published shape.

X is ``(features, samples)``, the layout ``repro_torch`` takes. Each
feature's document frequency follows a Zipf law: feature of rank ``r``
appears in a sample with probability ``min(1, (1 + C / r) / n)``, ``C``
fitted so the expected nonzeros are ``nnz_per_sample * n``; the ranks are
dealt to the features in a seeded order. A nonzero is standard normal, and
each feature row is scaled by its standard deviation over all ``n``
entries, zeros included (no centering, which would densify the rows).
Labels are the median split of ``X^T w_true + noise * N(0, 1)``, with
``w_true`` ``planted_scale * N(0, 1)`` on ``planted`` features drawn from
the ``head`` most frequent ones.

Everything is drawn on ``device`` from one ``torch.Generator`` seeded with
the run's seed, in blocks of ``BLOCK_ROWS`` rows, so the same seed gives
the same bits on one kind of device. Only the Zipf fit (``m`` numbers) runs
on the host.
"""

from __future__ import annotations

import numpy as np
import torch

#: rows drawn per call: bounds the temporaries (two ``BLOCK_ROWS x n``
#: draws) while keeping the calls few
BLOCK_ROWS = 4096


def seed_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` taken modulo 2**63."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def zipf_frequencies(m: int, n: int, nnz: float) -> np.ndarray:
    """Per-rank probabilities ``min(1, (1 + C / r) / n)`` whose sum times
    ``n`` is ``nnz`` (``C`` by bisection), in descending order."""
    if not m <= nnz <= float(m) * n:
        raise ValueError(f"nonzeros {nnz} outside [{m}, {m * n}] for {m} x {n}")
    ranks = np.arange(1, m + 1, dtype=np.float64)

    def total(c):
        return float(np.minimum(n, 1.0 + c / ranks).sum())

    lo, hi = 0.0, float(n) * m
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if total(mid) < nnz else (lo, mid)
    return np.minimum(n, 1.0 + lo / ranks) / n


def make(cfg: dict, seed: int, device="cuda"):
    """``(X (m, n), y (n,))`` on ``device`` in ``cfg["dtype"]`` (float32):
    ``m = cfg["features"]``, ``n = cfg["samples"]``, expected nonzeros
    ``cfg["nnz_per_sample"] * n``; ``cfg["assumed"]`` gives ``planted``,
    ``planted_scale``, ``head`` and ``noise``."""
    m, n = int(cfg["features"]), int(cfg["samples"])
    a = cfg["assumed"]
    dtype = getattr(torch, cfg.get("dtype", "float32"))
    dev = torch.device(device)
    g = seed_generator(seed, dev)
    p_rank = torch.as_tensor(zipf_frequencies(m, n, cfg["nnz_per_sample"] * n),
                             dtype=torch.float32, device=dev)
    order = torch.randperm(m, generator=g, device=dev)
    p = torch.empty((m,), dtype=torch.float32, device=dev)
    p[order] = p_rank          # feature order[r] has rank r + 1
    X = torch.empty((m, n), dtype=dtype, device=dev)
    for r0 in range(0, m, BLOCK_ROWS):
        r1 = min(m, r0 + BLOCK_ROWS)
        vals = torch.randn((r1 - r0, n), generator=g, device=dev)
        vals *= torch.rand((r1 - r0, n), generator=g, device=dev) < p[r0:r1, None]
        std = torch.sqrt(torch.clamp_min(
            vals.square().mean(1) - vals.mean(1).square(), 0.0))
        X[r0:r1] = vals / (std + 1e-12)[:, None]
        del vals
    head = order[: int(a["head"])]
    chosen = head[torch.randperm(head.numel(), generator=g, device=dev)[: int(a["planted"])]]
    w_true = float(a["planted_scale"]) * torch.randn(
        (chosen.numel(),), generator=g, device=dev)
    scores = X[chosen].to(torch.float64).t() @ w_true.to(torch.float64)
    scores += float(a["noise"]) * torch.randn((n,), generator=g, device=dev,
                                              dtype=torch.float64)
    y = torch.where(scores >= torch.quantile(scores, 0.5), 1.0, -1.0).to(dtype)
    return X, y
