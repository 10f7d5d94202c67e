"""The reference's sharded functions for ``tests/test_torch_distributed.py``,
run once in a subprocess with 8 host devices (as ``_distributed_inner.py``
runs them): ``python _torch_dist_reference.py IN.npz OUT.npz``.

Reads the test's inputs, runs ``screen_sharded`` and
``sample_surplus_sharded`` on the 2 x 2, 4 x 1 and 1 x 4 meshes and
``fista_sharded`` (static and with ``screen_every``) and the sharded scan
program on the 2 x 2 mesh, all at fixed iterations with the test's L (the
scan program is called with it, as ``svm_path_scan_sharded`` calls it
without), and writes what they return.
"""

import os
import re
import sys
from functools import partial

_flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                os.environ.get("XLA_FLAGS", ""))
os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core.distributed import (  # noqa: E402
    fista_sharded,
    mesh_collectives,
    sample_surplus_sharded,
    screen_sharded,
    shard_map,
    svm_mesh,
)
from repro.core.dual import bias_at_lambda_max, lambda_max, theta_at_lambda_max  # noqa: E402
from repro.core.path_scan import (  # noqa: E402
    ScanPathOutputs,
    _path_scan_program,
    _static_opts,
)

GRIDS = ((2, 2), (4, 1), (1, 4))


def scan_sharded(mesh, X, y, lambdas, L, rules, max_iters):
    """The body of the reference's ``svm_path_scan_sharded`` with an explicit
    L and no stop rule (tol = -1)."""
    m = X.shape[0]
    lmax = lambda_max(X, y)
    static_kw = _static_opts(max_iters, True, False, 1, False, False, "mask", rules,
                             None)
    col = mesh_collectives(mesh)

    def local_fn(Xb, yb, lams, w0b, b0b, th0b, d0b, lam0b, Lb, taub, tolb):
        return _path_scan_program(Xb, yb, lams, w0b, b0b, th0b, d0b, lam0b, Lb,
                                  taub, tolb, col=col, **dict(static_kw))

    in_specs = (P("model", "data"), P("data"), P(), P("model"), P(), P("data"), P(),
                P(), P(), P(), P())
    out_specs = ScanPathOutputs(
        w=P(None, "model"), b=P(), obj=P(), kept=P(), active=P(), n_iters=P(),
        converged=P(), gap=P(), delta=P(), fmask=P(None, "model"), cap=P(),
        resurrected=P(), health=P())
    fn = jax.jit(shard_map(local_fn, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_rep=False))
    return fn(X, y, jnp.asarray(lambdas, X.dtype), jnp.zeros((m,), X.dtype),
              bias_at_lambda_max(y), theta_at_lambda_max(y, lmax),
              jnp.asarray(0.0, X.dtype), lmax, jnp.asarray(L, X.dtype),
              jnp.asarray(1.0 - 2e-3, X.dtype), jnp.asarray(-1.0, X.dtype))


def main(src, dst):
    assert len(jax.devices()) == 8, jax.devices()
    d = dict(np.load(src))
    X, y = jnp.asarray(d["X"]), jnp.asarray(d["y"])
    lmax = lambda_max(X, y)
    theta0 = theta_at_lambda_max(y, lmax)
    out = {}
    for M, D in GRIDS:
        mesh = svm_mesh(model=M, data=D)
        tag = f"{M}x{D}"
        # jitted: an eager shard_map runs op by op, ~10 s a call here
        screen = jax.jit(partial(screen_sharded, mesh), static_argnames=("tau",))
        out[f"bounds0_{tag}"] = np.asarray(
            screen(X, y, lmax, 0.4 * lmax, theta0, delta=0.0)[1])
        out[f"bounds_s_{tag}"] = np.asarray(screen(
            X, y, float(d["lam1"]), float(d["lam2b"]), jnp.asarray(d["theta_s"]),
            delta=float(d["delta_s"]))[1])
        surplus, u1 = jax.jit(partial(sample_surplus_sharded, mesh))(
            X, y, jnp.asarray(d["w1"]), float(d["b1"]), float(d["dw"]),
            float(d["db"]), u_prev=jnp.asarray(d["u_prev"]))
        out[f"surplus_{tag}"], out[f"u1_{tag}"] = np.asarray(surplus), np.asarray(u1)
    mesh = svm_mesh(model=2, data=2)
    it, L, lam2 = int(d["iters"]), float(d["L"]), float(d["lam2"])
    r = fista_sharded(mesh, X, y, lam2, max_iters=it, tol=-1.0, L=L)
    out["static_w"], out["static_obj"] = np.asarray(r.w), float(r.obj)
    r = fista_sharded(mesh, X, y, lam2, max_iters=it, tol=-1.0, L=L,
                      screen_every=int(d["screen_every"]))
    out["dynamic_w"], out["dynamic_obj"] = np.asarray(r.w), float(r.obj)
    out["dynamic_fmask"] = np.asarray(r.feature_mask)
    outs = scan_sharded(mesh, X, y, d["lambdas"], L, "feature_vi", int(d["path_iters"]))
    out["scan_obj"], out["scan_kept"] = np.asarray(outs.obj), np.asarray(outs.kept)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
