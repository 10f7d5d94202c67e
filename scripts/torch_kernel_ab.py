"""Time an earlier version of the port's margin kernel against the current
one, in one process on one GPU, in turns (old, new, new, old), with the
gradient, sample-surplus and feature-screen kernels timed at both ends of
the run as controls that neither version changes.

    python scripts/torch_kernel_ab.py --old build/ab

``--old`` is a directory holding the earlier ``hinge.cu`` and the
``sweep.cuh`` it includes (for example ``git show
<commit>:src/repro_torch/kernels/csrc/hinge.cu``). They are built with the
same ``nvcc`` flags into a library of their own under that directory, and
the earlier ``margin_obj`` is called through its own C signature: the
blockIdx.y-split margin sweep, whose splits come from
:func:`_old_margin_splits` (a copy of the earlier wrapper's plan). The
current kernels go through their wrappers.

X is fp32 50,000 x 10,000 (2.0 GB), random from a seeded CUDA generator.
Each time is the mean of ``--reps`` calls (CUDA events). Both versions'
outputs are checked against the plain PyTorch version first. The library
call that computes ``u`` alone, ``torch.mv(X.t(), w)``, is timed beside
them.

With ``--path``, the paths of ``chip_smoke.py`` (the same data,
``make_sparse_classification(m=50_000, n=10_000, density=1.0, seed=0)``,
one L for every run) also run in turns, the solver's margin sweep and the
sample rule's verification sweep (``SampleVIRule.verify``) calling the
earlier kernel (through a wrapper that repeats the earlier Python side) or
the current one: the composite path (8 lambdas, lam_min_ratio 0.02) with
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

Prints one JSON line with the card's name and power limit. Needs a CUDA
GPU and nvcc.
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
import repro_torch.core.rules.sample_vi as sample_vi  # noqa: E402
import repro_torch.core.solver as solver  # noqa: E402
from repro_torch.core.path import PathDriver  # noqa: E402
from repro_torch.core.screening import shared_scalars  # noqa: E402
from repro_torch.core.solver import lipschitz_estimate  # noqa: E402
from repro_torch.data import make_sparse_classification  # noqa: E402
from repro_torch.kernels import build, hinge, screen  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier margin_obj: (X, x_bf16, w, y, b, n, valid_m, rows_per_split,
# splits, part, u, xi, loss_part, loss, device, stream)
OLD_MARGIN_SIGNATURE = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]
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


def build_old(src_dir: Path) -> ctypes.CDLL:
    out = src_dir / "libold_kernels.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(src_dir / "hinge.cu")], check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(out))
    lib.margin_obj.argtypes = OLD_MARGIN_SIGNATURE
    lib.margin_obj.restype = ctypes.c_int
    return lib


def old_margin_op(old: ctypes.CDLL):
    """The earlier margin kernel behind the current op's signature."""

    def margin(X, w, y, b, valid_m=None):
        m, n = X.shape
        vm = m if valid_m is None else int(valid_m)
        b = torch.as_tensor(b, dtype=torch.float32, device=X.device)
        rps, splits = _old_margin_splits(vm, n, X.device)
        f32 = dict(dtype=torch.float32, device=X.device)
        part = torch.empty((splits, n), **f32)
        u, xi = torch.empty(n, **f32), torch.empty(n, **f32)
        loss_part = torch.empty((-(-n // 256),), **f32)
        loss = torch.empty((), **f32)
        dev, stream = build.stream_and_device(X)
        build.check(old.margin_obj(
            X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(),
            y.data_ptr(), b.data_ptr(), n, vm, rps, splits, part.data_ptr(),
            u.data_ptr(), xi.data_ptr(), loss_part.data_ptr(), loss.data_ptr(),
            dev, stream), "old margin_obj")
        return u, xi, loss

    return margin


def _use(margin) -> None:
    solver.margin_obj_op = sample_vi.margin_obj_op = margin


def path_ab(old: ctypes.CDLL) -> dict:
    ds = make_sparse_classification(m=50_000, n=10_000, density=1.0, seed=0)
    X, y = torch.from_numpy(ds.X).cuda(), torch.from_numpy(ds.y).cuda()
    del ds
    L = float(lipschitz_estimate(X))
    new = solver.margin_obj_op
    versions = {"old": old_margin_op(old), "new": new}
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
    _use(new)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=Path("build/ab"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--path", action="store_true",
                    help="also run the composite and feature paths in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    old = build_old(args.old)
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

    margin_old = old_margin_op(old)
    want = hinge.margin_obj_plain(X, w, y, b)
    check = {}
    for label, fn in (("old", margin_old), ("new", hinge.margin_obj_op)):
        got = fn(X, w, y, b)
        check[f"margin_obj_{label}"] = max(float((p - q).abs().max())
                                           for p, q in zip(got, want))
    controls = {
        "hinge_grad": lambda: hinge.hinge_grad_op(X, y, xi),
        "sample_surplus": lambda: screen.sample_surplus_op(
            X, w, y, 0.1, 0.3, 0.02, u_prev),
        "screen_bounds": lambda: screen.screen_bounds_from_shared(X, y, theta, sh),
    }
    out = {"shape": [m, n], "dtype": "float32", "reps": args.reps,
           "max_abs_err_vs_plain": check}
    out["controls_before"] = {k: timed_ms(f, args.reps) for k, f in controls.items()}
    row = {}
    for label, fn in (("old", margin_old), ("new", hinge.margin_obj_op),
                      ("new2", hinge.margin_obj_op), ("old2", margin_old)):
        row[label] = timed_ms(lambda: fn(X, w, y, b), args.reps)
    out["margin_obj"] = row
    out["library"] = {"torch.mv(X.t(), w)": timed_ms(lambda: torch.mv(X.t(), w), args.reps)}
    out["controls_after"] = {k: timed_ms(f, args.reps) for k, f in controls.items()}
    out["margin_obj_profile"] = profile_ms(lambda: hinge.margin_obj_op(X, w, y, b))
    if args.path:
        out["paths"] = path_ab(old)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(json.dumps({"kernel_ab": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
