"""Time an earlier version of the port's hinge kernels against the current
one, in one process on one GPU, in turns (old, new, new, old), with the
kernels that the earlier version does not replace timed at both ends of
the run as controls; and time a launch that its predicate flag switches
off.

    python scripts/torch_kernel_ab.py --old build/ab --path
    python scripts/torch_kernel_ab.py --old build/ab_pred --old-kind unflagged

``--old`` is a directory holding the earlier ``hinge.cu`` and the
``sweep.cuh`` it includes (``git show <commit>:src/repro_torch/kernels/
csrc/hinge.cu``, likewise ``sweep.cuh``). They are built with the same
``nvcc`` flags into a library of their own under that directory and
called through the earlier C signature, which ``--old-kind`` names:

* ``split`` (PR 13's, ``a17e47b``): the blockIdx.y-split margin sweep,
  whose splits come from :func:`_old_margin_splits` (a copy of the earlier
  wrapper's plan). Only the margin is compared; the gradient is a control.
* ``unflagged`` (PR 16's, ``3d64315``): the margin and gradient sweeps
  before their predicate flag, launched with the current plans. Both are
  compared, and must equal the current unpredicated launches bit for bit.

The current kernels go through their wrappers, unpredicated, as the host
engine launches them.

X is fp32 50,000 x 10,000 (2.0 GB), random from a seeded CUDA generator.
Each time is the mean of ``--reps`` calls (CUDA events). Both versions'
outputs are checked against the plain PyTorch version first, and against
each other bit for bit. The library calls that compute ``u`` alone,
``torch.mv(X.t(), w)``, and ``g`` alone, ``torch.mv(X, y * xi)``, are
timed beside them. A margin and a gradient launch whose flag is 0 (the
restart's sweeps on an iteration without a restart) are timed eagerly
(host-bound: the wrapper's Python) and replayed from a CUDA graph of
``--reps`` such launches (the device's cost).

With ``--path``, the paths of ``chip_smoke.py`` (the same data,
``make_sparse_classification(m=50_000, n=10_000, density=1.0, seed=0)``,
one L for every run) also run in turns, the solver's sweeps calling the
earlier kernels (through wrappers that repeat the earlier Python side) or
the current ones: the composite path (8 lambdas, lam_min_ratio 0.02) with
the default stop rule (new as a warm-up, then old, new, new, old; the
iteration counts may differ, since the two versions sum in other orders)
and with exactly 100 iterations a step (old, new, new, old, old, new, new,
old: the same work), and the feature path (8 lambdas, lam_min_ratio 0.1)
with exactly 100 iterations a step (new as a warm-up, then old, new, new,
old, old, new, new, old twice: its runs are shorter and spread more). Each
run reports the path wall, the iterations and the solve time per
iteration.

``torch.profiler`` also records 20 calls of the current margin op and
reports each CUDA kernel's device time a call (the column sweep, the
finalizer and the loss sum).

Prints one JSON line with the card's name and power limit; exits 1 when
an ``unflagged`` comparison is not bit for bit. Needs a CUDA GPU and nvcc.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import repro_torch.core.solver as solver  # noqa: E402
from repro_torch.core.path import PathDriver  # noqa: E402
from repro_torch.core.screening import shared_scalars  # noqa: E402
from repro_torch.core.solver import lipschitz_estimate  # noqa: E402
from repro_torch.data import make_sparse_classification  # noqa: E402
from repro_torch.kernels import build, hinge, screen  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the earlier entry points' C signatures, by --old-kind
OLD_SIGNATURES = {
    # margin_obj: (X, x_bf16, w, y, b, n, valid_m, rows_per_split, splits,
    # part, u, xi, loss_part, loss, device, stream)
    "split": {"margin_obj": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                             _I, _P]},
    # the current signatures without the trailing (flag, skipped) pointers
    "unflagged": {
        "margin_obj": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                       _P, _P, _P, _I, _P],
        "hinge_grad": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    },
}
FIXED_ITERS = 100  # FISTA iterations a step in the fixed-work paths


def _old_margin_splits(valid_m: int, n: int, device) -> tuple[int, int]:
    """``(rows_per_split, splits)`` of the earlier margin sweep: 256 columns
    a block, the live rows cut across blockIdx.y to aim for 4 blocks an SM,
    at least 64 rows a split."""
    col_blocks = -(-n // 256)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-4 * sms // col_blocks))
    splits = max(1, min(want, valid_m // 64))
    rows_per_split = max(1, -(-valid_m // splits))
    return rows_per_split, max(1, -(-valid_m // rows_per_split))


def timed_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def build_old(src_dir: Path, kind: str) -> ctypes.CDLL:
    out = src_dir / "libold_kernels.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(src_dir / "hinge.cu")], check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in OLD_SIGNATURES[kind].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _unpredicated(flag) -> None:
    if flag is not None:
        raise ValueError("the earlier kernels take no predicate flag")


def old_ops(old: ctypes.CDLL, kind: str) -> dict:
    """The earlier kernels behind the current ops' signatures, by name."""
    f32 = dict(dtype=torch.float32)

    def split_margin(X, w, y, b, valid_m=None, flag=None):
        _unpredicated(flag)
        m, n = X.shape
        vm = m if valid_m is None else int(valid_m)
        b = torch.as_tensor(b, dtype=torch.float32, device=X.device)
        rps, splits = _old_margin_splits(vm, n, X.device)
        part = torch.empty((splits, n), **f32, device=X.device)
        u, xi = torch.empty(n, **f32, device=X.device), torch.empty(n, **f32, device=X.device)
        loss_part = torch.empty((-(-n // 256),), **f32, device=X.device)
        loss = torch.empty((), **f32, device=X.device)
        dev, stream = build.stream_and_device(X)
        build.check(old.margin_obj(
            X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(),
            y.data_ptr(), b.data_ptr(), n, vm, rps, splits, part.data_ptr(),
            u.data_ptr(), xi.data_ptr(), loss_part.data_ptr(), loss.data_ptr(),
            dev, stream), "old margin_obj")
        return u, xi, loss

    def unflagged_margin(X, w, y, b, valid_m=None, flag=None):
        _unpredicated(flag)
        m, n = X.shape
        vm = m if valid_m is None else int(valid_m)
        b = torch.as_tensor(b, dtype=torch.float32, device=X.device)
        plan = hinge.column_sweep_plan(vm, n, X.element_size(), hinge.bulk_aligned(X),
                                       hinge.sm_count(X.device))
        part = torch.empty(plan.scratch_shape(1), **f32, device=X.device)
        u, xi = torch.empty(n, **f32, device=X.device), torch.empty(n, **f32, device=X.device)
        loss_part = torch.empty((-(-n // 256),), **f32, device=X.device)
        loss = torch.empty((), **f32, device=X.device)
        dev, stream = build.stream_and_device(X)
        build.check(old.margin_obj(
            X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(), y.data_ptr(),
            b.data_ptr(), n, vm, int(plan.bulk), plan.grid, plan.seg_cols, plan.slabs,
            plan.stage_rows, plan.stages, part.data_ptr(), u.data_ptr(), xi.data_ptr(),
            loss_part.data_ptr(), loss.data_ptr(), dev, stream), "old margin_obj")
        return u, xi, loss

    def unflagged_grad(X, y, xi, valid_m=None, flag=None):
        _unpredicated(flag)
        m, n = X.shape
        vm = m if valid_m is None else int(valid_m)
        plan = hinge.grad_plan(vm, n, X.element_size(), hinge.bulk_aligned(X),
                               hinge.sm_count(X.device))
        g = torch.empty((m,), **f32, device=X.device)
        dev, stream = build.stream_and_device(X)
        build.check(old.hinge_grad(
            X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(), xi.data_ptr(),
            m, n, vm, int(plan.bulk), plan.grid, plan.chunk_cols, plan.piece_cols,
            plan.stages, g.data_ptr(), dev, stream), "old hinge_grad")
        return g

    if kind == "split":
        return {"margin_obj": split_margin}
    return {"margin_obj": unflagged_margin, "hinge_grad": unflagged_grad}


def _use(kernels: dict) -> None:
    for name, fn in kernels.items():
        setattr(solver, f"{name}_op", fn)


def path_ab(olds: dict) -> dict:
    ds = make_sparse_classification(m=50_000, n=10_000, density=1.0, seed=0)
    X, y = torch.from_numpy(ds.X).cuda(), torch.from_numpy(ds.y).cuda()
    del ds
    L = float(lipschitz_estimate(X))
    versions = {"old": olds, "new": {name: getattr(solver, f"{name}_op") for name in olds}}
    fixed = dict(tol=-1.0, max_iters=FIXED_ITERS)
    out = {}
    # (name, rules, lam_min_ratio, solver settings, warm-up first, order)
    turns = ("old", "new", "new", "old", "old", "new", "new", "old")
    runs = [("composite_default", "composite", 0.02, {}, True, turns[:4]),
            ("composite_fixed_iters", "composite", 0.02, fixed, False, turns),
            ("feature_fixed_iters", "feature_vi", 0.1, fixed, True, turns * 2)]
    for mode, rules, ratio, kw, warm, order in runs:
        rows = []
        for k, label in enumerate(("new",) * warm + order):
            _use(versions[label])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = PathDriver(rules, L=L, device="cuda", **kw).run(
                X, y, n_lambdas=8, lam_min_ratio=ratio)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            iters = int(res.solver_iters.sum())
            solve = float(res.extras["solve_times"].sum())
            if warm and k == 0:
                continue
            rows.append({"version": label, "path_wall_s": wall,
                         "iters": res.solver_iters.tolist(), "solve_s": solve,
                         "solve_ms_per_iter": 1e3 * solve / iters,
                         "kept": res.kept.tolist(),
                         "kept_samples": res.kept_samples.tolist()})
        out[mode] = rows
    _use(versions["new"])
    return out


def profile_ms(fn, reps=20) -> dict:
    """Device time a call of each CUDA kernel that ``fn`` launches
    (``torch.profiler``, ``reps`` calls after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out[e.key] = {"ms": us / reps / 1e3, "count": e.count}
    return out


def switched_off_ms(calls: dict, reps: int) -> dict:
    """Each call's time with its flag 0: eagerly, and a launch replayed from
    a CUDA graph of ``reps`` of them, as the solver's graphs replay it."""
    out = {name: {"eager_ms": timed_ms(f, reps)} for name, f in calls.items()}
    for name, f in calls.items():
        f()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                f()
        out[name]["in_graph_ms"] = timed_ms(graph.replay, 5) / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=Path("build/ab"))
    ap.add_argument("--old-kind", choices=tuple(OLD_SIGNATURES), default="split",
                    help="the earlier hinge.cu's C signature (see the module docstring)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--path", action="store_true",
                    help="also run the composite and feature paths in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    olds = old_ops(build_old(args.old, args.old_kind), args.old_kind)
    build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    m, n = 50_000, 10_000
    X = torch.randn(m, n, device="cuda", generator=g)
    y = torch.where(torch.rand(n, device="cuda", generator=g) < 0.5, 1.0, -1.0)
    xi = torch.rand(n, device="cuda", generator=g)
    w = torch.randn(m, device="cuda", generator=g) * 0.01
    u_prev = torch.randn(n, device="cuda", generator=g)
    b = torch.tensor(0.1, device="cuda")
    theta = torch.rand(n, device="cuda", generator=g) / 5.0
    sh = shared_scalars(y, 5.0, 3.0, theta, delta=1e-3)

    args_of = {"margin_obj": (X, w, y, b), "hinge_grad": (X, y, xi)}
    news = {"margin_obj": hinge.margin_obj_op, "hinge_grad": hinge.hinge_grad_op}
    plains = {"margin_obj": hinge.margin_obj_plain, "hinge_grad": hinge.hinge_grad_plain}
    check, same = {}, {}
    for name, old in olds.items():
        want = plains[name](*args_of[name])
        got = {"old": old(*args_of[name]), "new": news[name](*args_of[name])}
        for label, v in got.items():
            check[f"{name}_{label}"] = max(float((p - q).abs().max())
                                           for p, q in zip(v, want)) \
                if isinstance(v, tuple) else float((v - want).abs().max())
        same[name] = (all(torch.equal(p, q) for p, q in zip(got["old"], got["new"]))
                      if isinstance(want, tuple) else torch.equal(got["old"], got["new"]))
    controls = {
        "hinge_grad": lambda: hinge.hinge_grad_op(X, y, xi),
        "sample_surplus": lambda: screen.sample_surplus_op(
            X, w, y, 0.1, 0.3, 0.02, u_prev),
        "screen_bounds": lambda: screen.screen_bounds_from_shared(X, y, theta, sh),
    }
    controls = {k: f for k, f in controls.items() if k not in olds}
    out = {"shape": [m, n], "dtype": "float32", "reps": args.reps,
           "old_kind": args.old_kind, "max_abs_err_vs_plain": check,
           "bitwise_equal": same, "order": "old, new, new, old"}
    out["controls_before"] = {k: timed_ms(f, args.reps) for k, f in controls.items()}
    for name, old in olds.items():
        out[name] = {label: timed_ms(lambda: fn(*args_of[name]), args.reps)
                     for label, fn in (("old", old), ("new", news[name]),
                                       ("new2", news[name]), ("old2", old))}
    out["library"] = {"torch.mv(X.t(), w)": timed_ms(lambda: torch.mv(X.t(), w), args.reps),
                      "torch.mv(X, y * xi)": timed_ms(lambda: torch.mv(X, y * xi), args.reps)}
    out["controls_after"] = {k: timed_ms(f, args.reps) for k, f in controls.items()}
    off = torch.zeros((), dtype=torch.int32, device="cuda")
    out["switched_off_ms"] = switched_off_ms(
        {"margin_obj": lambda: hinge.margin_obj_op(X, w, y, b, flag=off),
         "hinge_grad": lambda: hinge.hinge_grad_op(X, y, xi, flag=off)}, args.reps)
    out["margin_obj_profile"] = profile_ms(lambda: hinge.margin_obj_op(X, w, y, b))
    if args.path:
        out["paths"] = path_ab(olds)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(json.dumps({"kernel_ab": out}))
    return 1 if args.old_kind == "unflagged" and not all(same.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
