"""The full kernel launches of an earlier kernel library against the current
one's, bit for bit and in turns, on one GPU: do the kernels launch as they
did before the current sources' additions (the partial modes)?

    git show 2a7b664:src/repro_torch/kernels/csrc/hinge.cu > build/ab_old/hinge.cu
    (likewise sample.cu, screen.cu, sweep.cuh)
    python scripts/torch_modes_off_ab.py --old build/ab_old

``--old`` holds the earlier ``csrc`` sources, whose entry points
``margin_obj``, ``hinge_grad``, ``screen_bounds_features`` and
``screen_bounds_samples`` take the current C signatures (commit 2a7b664's
do). They are built with the same ``nvcc`` flags into a library of their
own under that directory; the current wrappers then run once on the
current library and once on the earlier one (swapped in as
``kernels.build``'s loaded library), on the same inputs: the margin (all
rows live, a third live, predicated on and off), the gradient, the feature
screen's VI mode (with and without its ``d_theta`` output), dynamic
variant and EDPP mode, the sample surplus (with history and radii), at X
fp32 50,000 x 10,000 and on a ragged bf16 view (301 x 203 rows at an odd
offset, the scalar variants). Every output must be equal bit for bit. The
margin, gradient, VI screen and sample surplus are then timed in turns
(old, new, new, old; CUDA-event means of ``--reps`` calls). Prints one
JSON line with the card's name and power limit. Needs a CUDA GPU and nvcc.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core.screening import edpp_scalars, shared_scalars  # noqa: E402
from repro_torch.kernels import build, hinge, screen  # noqa: E402

OLD_ENTRY_POINTS = ("margin_obj", "hinge_grad", "screen_bounds_features",
                    "screen_bounds_samples")


def old_library(old_dir: Path) -> ctypes.CDLL:
    """The earlier sources built into ``old_dir/libold_kernels.so``."""
    nvcc, objs = build._nvcc(), []
    for src in sorted(old_dir.glob("*.cu")):
        obj = old_dir / (src.stem + ".o")
        out = subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}: {out.stdout}{out.stderr}")
        objs.append(str(obj))
    lib_path = old_dir / "libold_kernels.so"
    out = subprocess.run([nvcc, "-shared", "-o", str(lib_path), *objs],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc link failed: {out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for name in OLD_ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build.SIGNATURES[name], ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def calls(X, gen):
    """The full launches, by name, as closures over fixed inputs."""
    m, n = X.shape
    dev = X.device
    w = (torch.randn(m, generator=gen) * 0.01).to(dev)
    y = torch.where(torch.rand(n, generator=gen) < 0.6, 1.0, -1.0).to(dev)
    xi = torch.rand(n, generator=gen).to(dev)
    theta = (torch.rand(n, generator=gen) / 5.0).to(dev)
    s = (torch.rand(n, generator=gen) < 0.7).float().to(dev)
    u_prev = torch.randn(n, generator=gen).to(dev)
    b = torch.tensor(0.1, device=dev)
    on, off = (torch.tensor([v], dtype=torch.int32, device=dev) for v in (1, 0))
    sh = shared_scalars(y, 5.0, 3.0, theta, delta=1e-3)
    e = edpp_scalars(y, 5.0, 3.0, theta, delta=1e-3)
    shd = shared_scalars(y, 4.0, 4.0, theta * s, delta=0.05)
    cap = torch.tensor(0.05, device=dev)
    out = torch.full((n,), 7.0, device=dev), torch.full((n,), 7.0, device=dev)
    loss = torch.full((), 7.0, device=dev)
    return {
        "margin": lambda: hinge.margin_obj_op(X, w, y, b),
        "margin_third": lambda: hinge.margin_obj_op(X, w, y, b, m // 3),
        "margin_flag_on": lambda: hinge.margin_obj_op(X, w, y, b, flag=on),
        "margin_flag_off": lambda: hinge.margin_obj_op(X, w, y, b, flag=off,
                                                       out=(*out, loss)),
        "grad": lambda: (hinge.hinge_grad_op(X, y, xi),),
        "grad_third": lambda: (hinge.hinge_grad_op(X, y, xi, m // 3),),
        "screen_vi": lambda: (screen.screen_bounds_from_shared(X, y, theta, sh),),
        "screen_vi_d_theta": lambda: screen.screen_bounds_from_shared(
            X, y, theta, sh, want_d_theta=True),
        "screen_dynamic": lambda: (screen.screen_bounds_from_shared(
            X, y, theta * s, shd, s, cap),),
        "screen_edpp": lambda: (screen.screen_bounds_edpp(X, y, theta, sh, e),),
        "sample": lambda: screen.sample_surplus_op(X, w, y, 0.13, 0.37, 0.05, u_prev),
    }


def timed_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    new_lib, old_lib = build.library(), old_library(args.old)

    def on(lib, fn):
        build._lib = lib
        try:
            out = fn()
            torch.cuda.synchronize()
            return out
        finally:
            build._lib = new_lib

    gen = torch.Generator().manual_seed(3)
    full = torch.randn(50_000, 10_000, generator=gen).cuda()
    ragged = torch.randn(302, 203, generator=gen).to("cuda", torch.bfloat16)[1:]
    result = {"nvidia_smi": smi.stdout.strip(), "bitwise_equal": {}, "ms": {}}
    for tag, X in (("full", full), ("ragged_bf16_view", ragged)):
        for name, fn in calls(X, torch.Generator().manual_seed(4)).items():
            a, c = on(new_lib, fn), on(old_lib, fn)
            result["bitwise_equal"][f"{tag} {name}"] = all(
                torch.equal(p, q) for p, q in zip(a, c))
    for name, fn in calls(full, torch.Generator().manual_seed(5)).items():
        if name in ("margin", "grad", "screen_vi", "sample"):
            result["ms"][name] = [on(lib, lambda: timed_ms(fn, args.reps))
                                  for lib in (old_lib, new_lib, new_lib, old_lib)]
    result["order"] = "old, new, new, old"
    result["all_equal"] = all(result["bitwise_equal"].values())
    print(json.dumps(result), flush=True)
    return 0 if result["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
