"""Carry the reference package's state across to the port, and back.

:func:`state_from_numpy` turns the reference's arrays, as numpy, into the
port's tensors with checked dtypes and shapes, so both packages can be fed
one anchor and one Lipschitz bound. :func:`path_arrays` is the numpy view
of a :class:`~repro_torch.core.path.PathResult` (or of the reference's,
which has the same per-step fields). :func:`lm_params_from_jax` carries the
LM scaffold's parameter tree across, :func:`cache_arrays` is the numpy view
of the port's decode cache, :func:`train_state_from_jax` carries a train
state (parameters, AdamW moments and step) across, :func:`tree_keys`
(from :mod:`repro_torch.tree`) flattens a tree by its paths.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .tree import tree_keys

__all__ = ["STATE_NDIM", "state_from_numpy", "path_arrays", "PATH_FIELDS",
           "lm_params_from_jax", "train_state_from_jax", "cache_arrays", "tree_keys"]

#: the state the port takes from the reference, by name: its rank
STATE_NDIM = {"X": 2, "y": 1, "w": 1, "b": 0, "theta": 1, "delta": 0, "L": 0,
              "lambdas": 1, "w1": 1, "u_prev": 1}

#: the per-step arrays both packages' PathResult carry
PATH_FIELDS = ("lambdas", "weights", "biases", "objectives", "kept", "active",
               "solver_iters", "kept_samples", "verify_rounds")


def state_from_numpy(arrays: dict, device) -> dict[str, torch.Tensor]:
    """Tensors on ``device`` from a dict of numpy arrays (any subset of
    :data:`STATE_NDIM`). ``lambdas`` is float64 (the reference validates its
    grid in float64); everything else is float32, as the reference's fp32
    state. Shapes must agree: X (m, n), y, theta and u_prev (the sample
    rule's margin history) (n,), w and w1 (the primal anchor) (m,), lambdas
    a strictly positive vector. Raises ``ValueError``/``TypeError``
    otherwise.
    """
    unknown = set(arrays) - set(STATE_NDIM)
    if unknown:
        raise ValueError(f"unknown state keys {sorted(unknown)}; "
                         f"expected a subset of {sorted(STATE_NDIM)}")
    out = {}
    for name, value in arrays.items():
        a = np.asarray(value)
        want = np.float64 if name == "lambdas" else np.float32
        if a.dtype != want:
            raise TypeError(f"{name} must be {np.dtype(want).name}, got {a.dtype}")
        if a.ndim != STATE_NDIM[name]:
            raise ValueError(f"{name} must have rank {STATE_NDIM[name]}, got "
                             f"shape {a.shape}")
        out[name] = torch.tensor(a, device=device)  # a copy: a may be read-only
    m, n = out["X"].shape if "X" in out else (None, None)
    sizes = {"y": n, "theta": n, "u_prev": n, "w": m, "w1": m}
    for name, size in sizes.items():
        if name in out and size is not None and out[name].shape[0] != size:
            raise ValueError(f"{name} has length {out[name].shape[0]}, X is "
                             f"({m}, {n})")
    if "lambdas" in out and not bool(torch.all(out["lambdas"] > 0)):
        raise ValueError("lambdas must be positive")
    return out


def path_arrays(result) -> dict[str, np.ndarray]:
    """Numpy copies of a PathResult's per-step arrays (:data:`PATH_FIELDS`)."""
    return {name: np.asarray(getattr(result, name)) for name in PATH_FIELDS}


def lm_params_from_jax(tree, cfg, device="cuda"):
    """The reference's ``init_params`` tree (its leaves as numpy arrays,
    e.g. ``jax.tree_util.tree_map(np.asarray, params)``) as the port's
    parameter tree on ``device``. Keys, list lengths, shapes and dtypes must
    be those of the port's own tree for ``cfg``
    (``models.transformer.param_shapes``; each segment's slots stacked on
    their leading ``n_units`` axis in both packages, the enc-dec encoder's
    layers on ``enc_layers``), every leaf float32: ``cfg.param_dtype``
    float32, and the reference's ssm and rec leaves ``A_log``, ``D``,
    ``dt_bias`` and ``lam`` are float32 whatever the param dtype. Raises
    ``ValueError``/``TypeError`` otherwise.
    """
    from .models.transformer import param_shapes  # lazy: the SVM side needs no LM

    dev = resolve_device(device)
    if cfg.param_dtype != "float32":
        raise TypeError(f"param_dtype {cfg.param_dtype!r}: numpy carries float32 only")

    def conv(got, want, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                raise ValueError(f"{path or 'params'}: keys "
                                 f"{sorted(got) if isinstance(got, dict) else type(got)}, "
                                 f"expected {sorted(want)}")
            return {k: conv(got[k], want[k], f"{path}/{k}") for k in want}
        if isinstance(want, list):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(f"{path}: expected a list of {len(want)}")
            return [conv(g, w, f"{path}/{i}") for i, (g, w) in enumerate(zip(got, want))]
        a = np.asarray(got)
        if a.dtype != np.float32:
            raise TypeError(f"{path} must be float32, got {a.dtype}")
        if a.shape != tuple(want):
            raise ValueError(f"{path} has shape {a.shape}, expected {tuple(want)}")
        return torch.tensor(a, device=dev)  # a copy: a may be read-only

    return conv(tree, param_shapes(cfg), "")


def train_state_from_jax(state, cfg, device="cuda"):
    """The reference's ``TrainState`` (``repro.launch.steps``: ``params``
    and ``opt`` = ``AdamWState(step, mu, nu)``, leaves as numpy or JAX
    arrays) as the port's ``launch.steps.TrainState`` on ``device``: the
    parameters and both moments through :func:`lm_params_from_jax` (float32
    moments), the step an int32 tensor. Both packages then start a step
    from the same state."""
    from .launch.steps import TrainState  # lazy: the SVM side needs no LM
    from .optim.adamw import AdamWState

    dev = resolve_device(device)
    opt = state.opt
    step = np.asarray(opt.step)
    if step.shape != () or not np.issubdtype(step.dtype, np.integer):
        raise TypeError(f"opt.step must be an integer scalar, got {step.dtype} {step.shape}")
    return TrainState(
        params=lm_params_from_jax(state.params, cfg, dev),
        opt=AdamWState(step=torch.tensor(int(step), dtype=torch.int32, device=dev),
                       mu=lm_params_from_jax(opt.mu, cfg, dev),
                       nu=lm_params_from_jax(opt.nu, cfg, dev)))


def cache_arrays(cache) -> dict[str, np.ndarray]:
    """Float32 numpy copies of a decode cache's leaves (bf16 has no numpy
    dtype), keyed ``"segments/<g>/<slot>/<leaf>"`` (k, v, ck, cv, c, r,
    conv, state, h) by :func:`tree_keys`, as the reference's cache is."""
    return {key: t.detach().float().cpu().numpy() for key, t in tree_keys(cache).items()}
