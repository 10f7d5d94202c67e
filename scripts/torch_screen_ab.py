"""Time an earlier version of the port's feature-screen kernel against the
current one, in one process on one GPU, in turns (old, new, new, old).

    python scripts/torch_screen_ab.py --old build/ab_screen \
        [--old-kind weighted_edpp] [--shapes 2048x10000,50000x10000]

``--old`` is a directory holding the earlier ``screen.cu`` (for example
``git show <commit>:src/repro_torch/kernels/csrc/screen.cu``). It is built
with the same ``nvcc`` flags into a library of its own under that
directory, and called through its own C signature: ``--old-kind split``
(the default) is the signature of commit 038c22d's kernel (no EDPP
argument), ``--old-kind edpp`` that of commits 3d64315 and cbc492e (an
EDPP argument, no ``d_theta`` output), ``--old-kind d_theta`` that of
commits 2a7b664 to abded6a (an EDPP argument and a ``d_theta`` output,
EDPP in the unweighted instantiation only), ``--old-kind weighted_edpp``
that of commits d522bb5 to a3d539d (the same signature, the weighted
instantiation's EDPP mode too, and the partial mode
``screen_partial_features`` without a launch plan). The current kernel is
launched through its wrapper's internals (``screen._launch_features``,
``screen_partial_op``), so both sides get the same packed scalars, packed
once a case.

At each shape of ``--shapes`` (default 50,000 x 10,000; X fp32, random from
a seeded CUDA generator), each case is timed in turns, old, new, new, old,
three ways: ``ms``, the mean of ``--reps`` back-to-back calls between CUDA
events (the host's time per call included, as ``chip_smoke.py``'s
``timed_ms`` measures it); ``device_ms``, ``--reps`` calls captured in one
CUDA graph and one replay timed with CUDA events, over ``--reps`` (the
device's time alone; an X smaller than the 50 MB L2 is partly read from
it); and ``cold_ms``, the same with the calls reading copies of X in turn,
200 MB or more in all (every call reads its X from HBM, as a streamed
chunk is). The cases: the VI mode, with its ``d_theta`` output
(as the chunked paths launch it), the dynamic variant with sample weights
and the gap-sphere cap, the weighted VI launch, the EDPP mode, the
weighted EDPP mode (``weighted_edpp`` only) and the partial mode's four sums
(``weighted_edpp`` only). Each case reports the largest difference between
the two versions' outputs and whether they are equal bit for bit; each
shape also times ``torch.mv(X, y * theta1)`` the three ways (the one library call
that reads the same bytes; it gives d_theta only) and the least time the
card could take (X's bytes at 3.35 TB/s). Prints one JSON line with the
card's name and power limit and the current kernels' ``-Xptxas -v`` lines.
Needs a CUDA GPU and nvcc.
"""

import argparse
import ctypes
import json
import math
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier screen_bounds_features: (X, x_bf16, y, theta, weights,
# scalars, m, n, bounds, [d_theta,] [edpp,] device, stream)
OLD_SIGNATURES = {"split": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P],
                  "edpp": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P],
                  "d_theta": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P],
                  "weighted_edpp": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P]}
# the earlier screen_partial_features: (X, x_bf16, y, theta, weights, m, n,
# sums, device, stream)
OLD_PARTIAL = [_P, _I, _P, _P, _P, _I, _I, _P, _I, _P]


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
    if kind == "weighted_edpp":
        lib.screen_partial_features.argtypes = OLD_PARTIAL
        lib.screen_partial_features.restype = ctypes.c_int
    return lib


def timed_ms(fn, reps: int) -> float:
    """Mean time of ``reps`` back-to-back calls between CUDA events."""
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


def device_ms(fn, reps: int, box=None, copies=()) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    one replay timed with CUDA events, over ``reps``; with ``copies``, call
    i reads ``copies[i % len(copies)]``, put in ``box[0]`` before it is
    captured."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            if copies:
                box[0] = copies[i % len(copies)]
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def in_turns(f_old, f_new, reps: int, box, copies) -> dict:
    order = (f_old, f_new, f_new, f_old)
    out = {"ms": [timed_ms(f, reps) for f in order],
           "device_ms": [device_ms(f, reps) for f in order],
           "cold_ms": [device_ms(f, reps, box, copies) for f in order]}
    box[0] = copies[0]
    return out


def run_shape(old, kind: str, m: int, n: int, reps: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7)
    X0 = torch.randn(m, n, generator=gen, device="cuda")
    copies = [X0] + [X0.clone() for _ in range(max(1, math.ceil(200e6 / (m * n * 4))) - 1)]
    box = [X0]  # the X the next call reads
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.6, 1.0, -1.0)
    theta = torch.rand(n, generator=gen, device="cuda") / 50.0
    s = (torch.rand(n, generator=gen, device="cuda") < 0.75).float()
    th_d = theta * s
    sh = shared_scalars(y, 60.0, 40.0, theta, delta=1e-3)
    e = edpp_scalars(y, 60.0, 40.0, theta, delta=1e-3)
    lam = torch.tensor(40.0, device="cuda")
    kw = dict(one_y=torch.sum(y * s), theta_dot_one=torch.sum(th_d),
              theta_dot_y=th_d @ y, theta_sq=th_d @ th_d, n_tot=s.sum(),
              delta=torch.tensor(1e-3, device="cuda"))
    sh_d = shared_scalars_from_stats(lam, lam, **kw)
    e_d = edpp_scalars_from_stats(lam, lam, **kw)
    cap = torch.tensor(1e-3, device="cuda")

    def old_call(th, weights, scalars, edpp, with_d_theta=False):
        X = box[0]
        dev, stream = build.stream_and_device(X)  # a graph captures on its own stream
        out = torch.empty(m, device="cuda")
        d_theta = torch.empty(m, device="cuda") if with_d_theta else None
        mode = {"split": (), "edpp": (int(edpp),)}.get(
            kind, (None if d_theta is None else d_theta.data_ptr(), int(edpp)))
        err = old.screen_bounds_features(
            X.data_ptr(), 0, y.data_ptr(), th.data_ptr(),
            None if weights is None else weights.data_ptr(), scalars.data_ptr(),
            m, n, out.data_ptr(), *mode, dev, stream)
        build.check(err, "old screen_bounds_features")
        return out if d_theta is None else (out, d_theta)

    def old_partial():
        X = box[0]
        dev, stream = build.stream_and_device(X)
        sums = torch.empty((4, m), device="cuda")
        err = old.screen_partial_features(X.data_ptr(), 0, y.data_ptr(), theta.data_ptr(),
                                          s.data_ptr(), m, n, sums.data_ptr(), dev, stream)
        build.check(err, "old screen_partial_features")
        return sums

    def new_call(th, weights, scalars, edpp, name, with_d_theta=False):
        return screen._launch_features(box[0], y, th, scalars, weights, edpp, name,
                                       with_d_theta)

    packed = {"vi": screen.pack_shared(sh), "cap": screen.pack_shared(sh_d, cap),
              "weighted": screen.pack_shared(sh_d), "edpp": screen.pack_shared(sh, edpp=e),
              "weighted_edpp": screen.pack_shared(sh_d, edpp=e_d)}
    cases = {  # name: (theta, weights, packed scalars, edpp, launch count name)
        "vi": (theta, None, "vi", False, "screen_bounds"),
        "dynamic_weighted_capped": (th_d, s, "cap", False, "screen_bounds_dynamic"),
        "weighted": (th_d, s, "weighted", False, "screen_bounds_dynamic"),
    }
    if kind != "split":
        cases["edpp"] = (theta, None, "edpp", True, "screen_bounds_edpp")
    if kind == "weighted_edpp":
        cases["weighted_edpp"] = (th_d, s, "weighted_edpp", True, "screen_bounds_edpp_weighted")
    pairs = {name: ((lambda c=c: old_call(c[0], c[1], packed[c[2]], c[3])),
                    (lambda c=c: new_call(c[0], c[1], packed[c[2]], c[3], c[4])))
             for name, c in cases.items()}
    if kind in ("d_theta", "weighted_edpp"):
        pairs["vi_d_theta"] = (
            lambda: old_call(theta, None, packed["vi"], False, True),
            lambda: new_call(theta, None, packed["vi"], False, "screen_bounds", True))
    if kind == "weighted_edpp":
        pairs["partial_weighted"] = (old_partial,
                                     lambda: screen.screen_partial_op(box[0], y, theta, s))
    out = {"shape": [m, n], "bound_ms": m * n * 4 / HBM_BYTES_PER_S * 1e3,
           "copies": len(copies), "plan": screen.screen_plan(
               m, n, 4, True, torch.cuda.get_device_properties(0).multi_processor_count
           )._asdict()}
    for name, (f_old, f_new) in pairs.items():
        a, b = f_old(), f_new()
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        diff = max(float((p - q).abs().max()) for p, q in zip(a, b))
        scale = max(float(p.abs().max()) for p in a)
        out[name] = {**in_turns(f_old, f_new, reps, box, copies), "max_abs_diff_old_new": diff,
                     "max_rel_diff_old_new": diff / max(scale, 1e-30),
                     "bitwise_equal": all(torch.equal(p, q) for p, q in zip(a, b))}
    v = y * theta
    mv = lambda: torch.mv(box[0], v)  # noqa: E731
    out["torch_mv"] = {"ms": timed_ms(mv, reps), "device_ms": device_ms(mv, reps),
                       "cold_ms": device_ms(mv, reps, box, copies)}
    del X0, copies, box
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--old-kind", choices=sorted(OLD_SIGNATURES), default="split")
    ap.add_argument("--shapes", default="50000x10000",
                    help="comma-separated m x n shapes, e.g. 2048x10000,50000x10000")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    old = old_library(args.old, args.old_kind)
    build.library()
    log = build.build_log().split("== ")
    ptxas = [ln.strip() for part in log if part.startswith("screen.cu")
             for ln in part.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    res = {"script": "scripts/torch_screen_ab.py", "nvidia_smi": smi.stdout.strip(),
           "reps": args.reps, "order": "old, new, new, old", "old_kind": args.old_kind,
           "ptxas_screen": ptxas, "shapes": []}
    for shape in args.shapes.split(","):
        m, n = (int(v) for v in shape.lower().split("x"))
        res["shapes"].append(run_shape(old, args.old_kind, m, n, args.reps))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
