"""Time an earlier version of the port's gradient and sample-surplus kernels
against the current one, in one process on one GPU, in turns (old, new,
new, old), with the margin and feature-screen kernels timed beside them as
controls that neither version changes.

    python scripts/torch_kernel_ab.py --old build/ab

``--old`` is a directory holding the earlier ``hinge.cu`` and ``sample.cu``
(for example ``git show <commit>:src/repro_torch/kernels/csrc/hinge.cu``);
they are built with the same ``nvcc`` flags into a library of their own
under that directory and called through their own C signatures (the
one-warp-per-4-rows gradient and the blockIdx.y-split sample sweep, whose
splits come from ``kernels/hinge.py::margin_splits``). The current kernels
go through their wrappers.

X is fp32 50,000 x 10,000 (2.0 GB), random from a seeded CUDA generator.
Each time is the mean of ``--reps`` calls (CUDA events). Both versions'
outputs are checked against the plain PyTorch versions first.

With ``--path``, the composite path of ``chip_smoke.py`` (the same data,
``make_sparse_classification(m=50_000, n=10_000, density=1.0, seed=0)``,
8 lambdas, lam_min_ratio 0.02, one L for every run) also runs in turns,
its solver and sample rule calling the earlier kernels (through wrappers
that repeat the earlier Python side) or the current ones: with the default
stop rule (new as a warm-up, then old, new, new, old; the iteration counts
may differ, since the two versions sum in other orders) and with exactly
100 iterations a step (old, new, new, old, old, new, new, old: the same
work). Each run reports the path wall, the iterations and the solve time
per iteration.

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
OLD_SIGNATURES = {
    "margin_obj": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    "hinge_grad": [_P, _I, _P, _P, _I, _I, _I, _P, _I, _P],
    "screen_bounds_samples": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                              _P, _I, _P],
}
FIXED_ITERS = 100  # FISTA iterations a step in the fixed-work path runs


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
    srcs = [str(src_dir / "hinge.cu"), str(src_dir / "sample.cu")]
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                    *srcs], check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in OLD_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def old_ops(old: ctypes.CDLL):
    """The earlier kernels behind the current ops' signatures."""

    def grad(X, y, xi, valid_m=None):
        m, n = X.shape
        vm = m if valid_m is None else int(valid_m)
        g = torch.empty(m, dtype=torch.float32, device=X.device)
        dev, stream = build.stream_and_device(X)
        build.check(old.hinge_grad(X.data_ptr(), int(X.dtype == torch.bfloat16),
                                   y.data_ptr(), xi.data_ptr(), m, n, vm,
                                   g.data_ptr(), dev, stream), "old hinge_grad")
        return g

    def sample(X, w1, y, b1, dw=float("inf"), db=float("inf"), u_prev=None,
               shrink_factor=2.0, margin_floor=1e-3):
        m, n = X.shape
        sc = screen.pack_sample_scalars(b1, dw, db, shrink_factor, margin_floor,
                                        u_prev is not None, device=X.device)
        rps, splits = hinge.margin_splits(m, n, X.device)
        f32 = dict(dtype=torch.float32, device=X.device)
        part = torch.empty((2 * splits, n), **f32)
        u, surplus = torch.empty(n, **f32), torch.empty(n, **f32)
        dev, stream = build.stream_and_device(X)
        build.check(old.screen_bounds_samples(
            X.data_ptr(), int(X.dtype == torch.bfloat16), w1.data_ptr(),
            y.data_ptr(), (y if u_prev is None else u_prev).data_ptr(),
            sc.data_ptr(), m, n, rps, splits, part.data_ptr(), u.data_ptr(),
            surplus.data_ptr(), dev, stream), "old sample_surplus")
        return surplus, u

    return grad, sample


def path_ab(old: ctypes.CDLL) -> dict:
    ds = make_sparse_classification(m=50_000, n=10_000, density=1.0, seed=0)
    X, y = torch.from_numpy(ds.X).cuda(), torch.from_numpy(ds.y).cuda()
    del ds
    L = float(lipschitz_estimate(X))
    new = (solver.hinge_grad_op, sample_vi.sample_surplus_op)
    versions = {"old": old_ops(old), "new": new}
    out = {}
    # default stop rule, then exactly FIXED_ITERS iterations a step (the
    # same work for both versions), each in turns
    runs = [("default", {}, ("new", "old", "new", "new", "old")),
            ("fixed_iters", dict(tol=-1.0, max_iters=FIXED_ITERS),
             ("old", "new", "new", "old", "old", "new", "new", "old"))]
    for mode, kw, order in runs:
        rows = []
        for k, label in enumerate(order):
            solver.hinge_grad_op, sample_vi.sample_surplus_op = versions[label]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = PathDriver("composite", L=L, device="cuda", **kw).run(
                X, y, n_lambdas=8, lam_min_ratio=0.02)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            iters = int(res.solver_iters.sum())
            solve = float(res.extras["solve_times"].sum())
            if mode == "default" and k == 0:
                continue  # warm-up
            rows.append({"version": label, "path_wall_s": wall,
                         "iters": res.solver_iters.tolist(), "solve_s": solve,
                         "solve_ms_per_iter": 1e3 * solve / iters,
                         "kept_samples": res.kept_samples.tolist()})
        out[mode] = rows
    solver.hinge_grad_op, sample_vi.sample_surplus_op = new
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=Path("build/ab"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--path", action="store_true",
                    help="also run the composite path in turns")
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
    dev, stream = build.stream_and_device(X)
    f32 = dict(dtype=torch.float32, device="cuda")

    g_old = torch.empty(m, **f32)

    def grad_old():
        build.check(old.hinge_grad(X.data_ptr(), 0, y.data_ptr(), xi.data_ptr(),
                                   m, n, m, g_old.data_ptr(), dev, stream), "old grad")
        return g_old

    rps, splits = hinge.margin_splits(m, n, X.device)
    part = torch.empty((2 * splits, n), **f32)
    u_old, s_old = torch.empty(n, **f32), torch.empty(n, **f32)
    sc = screen.pack_sample_scalars(0.1, 0.3, 0.02, 2.0, 1e-3, True, device="cuda")

    def sample_old():
        build.check(old.screen_bounds_samples(
            X.data_ptr(), 0, w.data_ptr(), y.data_ptr(), u_prev.data_ptr(),
            sc.data_ptr(), m, n, rps, splits, part.data_ptr(), u_old.data_ptr(),
            s_old.data_ptr(), dev, stream), "old sample")
        return s_old, u_old

    pair = {
        "hinge_grad": (grad_old, lambda: hinge.hinge_grad_op(X, y, xi)),
        "sample_surplus": (sample_old, lambda: screen.sample_surplus_op(
            X, w, y, 0.1, 0.3, 0.02, u_prev)),
    }
    check = {}
    want_g = hinge.hinge_grad_plain(X, y, xi)
    want_s = screen.sample_surplus_plain(X, w, y, 0.1, 0.3, 0.02, u_prev)
    for label, fn in (("old", grad_old), ("new", pair["hinge_grad"][1])):
        check[f"hinge_grad_{label}"] = float((fn() - want_g).abs().max())
    for label, fn in (("old", sample_old), ("new", pair["sample_surplus"][1])):
        got = fn()
        check[f"sample_surplus_{label}"] = max(float((p - q).abs().max())
                                               for p, q in zip(got, want_s))
    controls = {
        "margin_obj": lambda: hinge.margin_obj_op(X, w, y, b),
        "screen_bounds": lambda: screen.screen_bounds_from_shared(X, y, theta, sh),
    }
    out = {"shape": [m, n], "dtype": "float32", "reps": args.reps,
           "max_abs_err_vs_plain": check}
    out["controls_before"] = {k: timed_ms(f, args.reps) for k, f in controls.items()}
    for name, (f_old, f_new) in pair.items():
        row = {}
        for label, fn in (("old", f_old), ("new", f_new), ("new2", f_new),
                          ("old2", f_old)):
            row[label] = timed_ms(fn, args.reps)
        out[name] = row
    v = y * xi
    out["library"] = {"torch.mv(X, v)": timed_ms(lambda: torch.mv(X, v), args.reps),
                      "torch.mv(X.t(), w1)": timed_ms(lambda: torch.mv(X.t(), w), args.reps)}
    out["controls_after"] = {k: timed_ms(f, args.reps) for k, f in controls.items()}
    if args.path:
        out["composite_path"] = path_ab(old)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(json.dumps({"kernel_ab": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
