"""Time an earlier version of the port's feature-screen kernel against the
current one, in one process on one GPU, in turns (old, new, new, old).

    python scripts/torch_screen_ab.py --old build/ab_screen

``--old`` is a directory holding the earlier ``screen.cu`` (for example
``git show <commit>:src/repro_torch/kernels/csrc/screen.cu``). It is built
with the same ``nvcc`` flags into a library of its own under that
directory, and called through its own C signature, with the scalars packed
on every call as the current wrapper packs them: ``--old-kind split`` (the
default) is the signature of commit 038c22d's kernel (no EDPP argument),
``--old-kind edpp`` that of commits 3d64315 and cbc492e (an EDPP argument,
no ``d_theta`` output), ``--old-kind d_theta`` that of commits 2a7b664 to
abded6a (an EDPP argument and a ``d_theta`` output, EDPP in the unweighted
instantiation only). The current kernel goes
through its wrappers. With ``--old-kind edpp`` or ``d_theta`` the EDPP
mode is compared too, and the current VI mode with its ``d_theta`` output
on: each case reports whether the two versions' bounds are equal bit for
bit.

Timed in turns at X fp32 50,000 x 10,000 (2.0 GB), random from a seeded
CUDA generator: the VI mode, then the dynamic variant with sample weights
and the gap-sphere cap, then with sample weights alone (the path server's
weighted VI launch), then the current EDPP mode beside the current VI mode
and the current weighted EDPP mode beside the current weighted VI mode. Each time is the mean of ``--reps`` calls (CUDA events). The largest
difference between the two versions' outputs is reported (the current VI
finalizer rounds as its explicit intrinsics say, the earlier one as the
compiler fused it, so the last bits may differ). Prints one JSON line with
the card's name and power limit. Needs a CUDA GPU and nvcc.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core.screening import (  # noqa: E402
    edpp_scalars,
    edpp_scalars_from_stats,
    shared_scalars,
    shared_scalars_from_stats,
)
from repro_torch.kernels import build, screen  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier screen_bounds_features: (X, x_bf16, y, theta, weights,
# scalars, m, n, bounds, [edpp,] device, stream)
OLD_SIGNATURES = {"split": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P],
                  "edpp": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P],
                  "d_theta": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P]}


def old_library(old_dir: Path, kind: str) -> ctypes.CDLL:
    src = old_dir / "screen.cu"
    lib_path = old_dir / "libold_screen.so"
    obj = old_dir / "screen.o"
    nvcc = build._nvcc()
    for cmd in ([nvcc, *build.NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                [nvcc, "-shared", "-o", str(lib_path), str(obj)]):
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed: {out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.screen_bounds_features.argtypes = OLD_SIGNATURES[kind]
    lib.screen_bounds_features.restype = ctypes.c_int
    return lib


def timed_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--old-kind", choices=sorted(OLD_SIGNATURES), default="split")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    old = old_library(args.old, args.old_kind)
    m, n = 50_000, 10_000
    gen = torch.Generator(device="cuda").manual_seed(7)
    X = torch.randn(m, n, generator=gen, device="cuda")
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.6, 1.0, -1.0)
    theta = torch.rand(n, generator=gen, device="cuda") / 50.0
    s = (torch.rand(n, generator=gen, device="cuda") < 0.75).float()
    sh = shared_scalars(y, 60.0, 40.0, theta, delta=1e-3)
    e = edpp_scalars(y, 60.0, 40.0, theta, delta=1e-3)
    lam = torch.tensor(40.0, device="cuda")
    sh_d = shared_scalars_from_stats(
        lam, lam, one_y=torch.sum(y * s), theta_dot_one=torch.sum(theta * s),
        theta_dot_y=(theta * s) @ y, theta_sq=(theta * s) @ (theta * s),
        n_tot=s.sum(), delta=torch.tensor(1e-3, device="cuda"))
    cap = torch.tensor(1e-3, device="cuda")
    dev, stream = build.stream_and_device(X)

    def old_call(th, weights, shared, cap_delta=None, edpp=None):
        # packs the scalars on every call, as the current wrapper does
        scalars = screen.pack_shared(shared, cap_delta, edpp=edpp)
        out = torch.empty(m, device="cuda")
        mode = {"split": (), "edpp": (int(edpp is not None),),
                "d_theta": (None, int(edpp is not None))}[args.old_kind]
        err = old.screen_bounds_features(
            X.data_ptr(), 0, y.data_ptr(), th.data_ptr(),
            None if weights is None else weights.data_ptr(), scalars.data_ptr(),
            m, n, out.data_ptr(), *mode, dev, stream)
        build.check(err, "old screen_bounds_features")
        return out

    th_d = theta * s
    cases = {
        "vi": (lambda: old_call(theta, None, sh),
               lambda: screen.screen_bounds_from_shared(X, y, theta, sh)),
        "dynamic_weighted_capped": (
            lambda: old_call(th_d, s, sh_d, cap),
            lambda: screen.screen_bounds_from_shared(X, y, th_d, sh_d, s, cap)),
        "weighted": (
            lambda: old_call(th_d, s, sh_d),
            lambda: screen.screen_bounds_from_shared(X, y, th_d, sh_d, s)),
    }
    if args.old_kind != "split":
        cases["edpp"] = (lambda: old_call(theta, None, sh, edpp=e),
                         lambda: screen.screen_bounds_edpp(X, y, theta, sh, e))
        cases["vi_new_with_d_theta"] = (
            lambda: old_call(theta, None, sh),
            lambda: screen.screen_bounds_from_shared(X, y, theta, sh,
                                                     want_d_theta=True)[0])
    res = {"script": "scripts/torch_screen_ab.py", "nvidia_smi": smi.stdout.strip(),
           "shape": [m, n], "reps": args.reps, "order": "old, new, new, old",
           "old_kind": args.old_kind}
    for name, (f_old, f_new) in cases.items():
        a, b = f_old(), f_new()
        res[name] = {"ms": [timed_ms(f, args.reps) for f in (f_old, f_new, f_new, f_old)],
                     "max_abs_diff_old_new": float((a - b).abs().max()),
                     "bitwise_equal": bool(torch.equal(a, b))}
    vi = lambda: screen.screen_bounds_from_shared(X, y, theta, sh)  # noqa: E731
    ed = lambda: screen.screen_bounds_edpp(X, y, theta, sh, e)  # noqa: E731
    res["edpp_vs_vi_new"] = {"order": "vi, edpp, edpp, vi",
                             "ms": [timed_ms(f, args.reps) for f in (vi, ed, ed, vi)],
                             "edpp_le_vi": bool((ed() <= vi()).all())}
    e_d = edpp_scalars_from_stats(
        lam, lam, one_y=torch.sum(y * s), theta_dot_one=torch.sum(th_d),
        theta_dot_y=th_d @ y, theta_sq=th_d @ th_d, n_tot=s.sum(),
        delta=torch.tensor(1e-3, device="cuda"))
    wvi = lambda: screen.screen_bounds_from_shared(X, y, th_d, sh_d, s)  # noqa: E731
    wed = lambda: screen.screen_bounds_edpp(X, y, th_d, sh_d, e_d, weights=s)  # noqa: E731
    res["weighted_edpp_vs_weighted_vi_new"] = {
        "order": "weighted vi, weighted edpp, weighted edpp, weighted vi",
        "ms": [timed_ms(f, args.reps) for f in (wvi, wed, wed, wvi)],
        "edpp_le_vi": bool((wed() <= wvi()).all())}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
