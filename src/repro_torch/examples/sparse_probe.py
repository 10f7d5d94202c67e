"""Sparse-probe head: the paper's technique attached to an LM backbone, as
the reference's ``examples/sparse_probe.py``:

  1. briefly train a small LM on the synthetic stream,
  2. freeze it and extract last-position features for a labeled probe task,
  3. treat the d_model feature dimensions as SVM *features* (the paper's
     layout, X: features x samples) and fit an L1-L2-SVM path with safe
     screening (``core.path.svm_path``) to select a sparse subset.

On the card step 3 runs the repository's feature-screen, margin and
gradient kernels. It runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.examples.sparse_probe [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core import svm_path
from ..data import TokenPipeline
from ..device import resolve_device
from ..launch.steps import init_train_state, make_train_step
from ..models import transformer as tr
from ..models.layers import embed, rmsnorm

STEPS, BATCH, SEQ = 30, 8, 64          # the backbone's training run
N_PROBE = 192                          # probe sequences of SEQ tokens
N_LAMBDAS, LAM_MIN_RATIO = 6, 0.15


@torch.no_grad()
def extract_features(params, cfg, tokens, chunk: int = 0) -> torch.Tensor:
    """Frozen-backbone features: the final-norm hidden state at the last
    position, (B, d_model) in the compute dtype; ``chunk`` sequences at a
    time (0: all at once). The reference embeds in float32 and promotes
    every product to float32; for a float32 config (the example's) that is
    the same, for a bf16 one the port keeps the residual stream in bf16."""
    act = tr._act_dtype(cfg)
    out = []
    for part in tokens.split(chunk or tokens.shape[0]):
        B, S = part.shape
        positions = torch.arange(S, device=part.device).expand(B, S)
        x = embed(params["embed"], part, act_dtype=act)
        x, _, _ = tr._run_segments(params, cfg, x, positions, None, None, "train")
        out.append(rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps))
    return torch.cat(out)


def probe_task(feats: torch.Tensor, tokens: np.ndarray) -> tuple:
    """``(X, y)``: the features as float32 ``(d_model, n)`` numpy, each row
    standardized, row-major (the kernels read rows); labels +1 where a
    sequence ends in an even token."""
    y = np.where(tokens[:, -1] % 2 == 0, 1.0, -1.0).astype(np.float32)
    X = feats.float().cpu().numpy().T.astype(np.float32)
    X = (X - X.mean(1, keepdims=True)) / (X.std(1, keepdims=True) + 1e-9)
    return np.ascontiguousarray(X), y


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype="float32")

    # 1) short backbone training run
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = make_train_step(cfg, total_steps=STEPS)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch_size=BATCH, seq_len=SEQ)
    for s in range(STEPS):
        state, metrics = step(state, {k: torch.from_numpy(v).to(dev)
                                      for k, v in pipe.batch_at(s).items()})
    print(f"[probe] backbone trained, final LM loss {metrics['loss']:.3f}")

    # 2) probe task: does the sequence end in an even token? (synthetic labels)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (N_PROBE, SEQ)).astype(np.int32)
    feats = extract_features(state.params, cfg, torch.from_numpy(toks).to(dev))
    X, y = probe_task(feats, toks)

    # 3) screened sparse-SVM path over the d_model feature dims
    path = svm_path(X, y, n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO, device=dev)
    print("[probe] kept feature-dims per lambda :", path.kept.tolist())
    print("[probe] active (selected) dims       :", path.active.tolist())
    sel = np.nonzero(np.abs(path.weights[-1]) > 1e-8)[0]
    print(f"[probe] final sparse probe uses {len(sel)}/{X.shape[0]} dims: "
          f"{sel[:12].tolist()}{'...' if len(sel) > 12 else ''}")

    # probe accuracy (train-set; demonstration)
    pred = np.sign(path.weights[-1] @ X + path.biases[-1])
    acc = float(np.mean(pred == y))
    print(f"[probe] fit accuracy {acc:.3f}")
    return {"path": path, "accuracy": acc, "loss": metrics["loss"]}


if __name__ == "__main__":
    main()
