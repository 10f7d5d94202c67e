"""Time the feature-screen kernel (``kernels/csrc/screen.cu``) under several
choices of its launch plan, in one process on one GPU, beside the PyTorch
call that reads the same bytes.

    python scripts/torch_screen_tune.py [--shapes 2048x10000,50000x10000]

A choice sets the plan's column split (``SCREEN_SEG_BYTES`` of
``kernels/screen.py``: a tile is one row's segment of at most that many
bytes) and its grid (``SCREEN_BLOCKS_PER_SM`` blocks an SM, at most the
kernel's two); ``scalar`` runs the scalar variant instead (X one item off a
16-byte boundary). ``--variants`` also builds copies of ``screen.cu`` (under
``build/screen_tune/``, with the package's ``nvcc`` flags, all at once)
whose compile-time constants are set as ``VARIANTS`` says (``kUnroll``, the
16-byte units a lane loads before it sums them; ``kBlocksPerSM``, with a grid
of that many waves), and times each at the default split. Each
choice launches the VI mode (fp32 X, random from a seeded CUDA generator)
through the package's library and is timed by its device time (``--reps``
calls captured in one CUDA graph, one replay timed with CUDA events, over
``--reps``); the first choice is repeated last, to show the drift within
the run. Choices with the same column split must give the same bits (the
summation order depends on the split alone). Each shape also times the
finalize kernel alone (on (4, m) sums) and ``torch.mv(X, y theta1)``.
Prints one JSON line with the card's name and power limit. Needs a CUDA
GPU and nvcc.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core.screening import shared_scalars  # noqa: E402
from repro_torch.kernels import build, hinge, screen  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (SCREEN_SEG_BYTES, blocks an SM, variant); the first is repeated last
CHOICES = [(8192, 2, "bulk"), (8192, 1, "bulk"), (4096, 2, "bulk"), (16384, 2, "bulk"),
           (8192, 2, "scalar"), (8192, 2, "bulk")]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# --variants: name -> (compile-time constants of csrc/screen.cu, blocks an SM)
VARIANTS = {"as_built": ({}, 2), "unroll_4": ({"kUnroll": "4"}, 2),
            "blocks_3": ({"kBlocksPerSM": "3"}, 3),
            "unroll_4_blocks_3": ({"kUnroll": "4", "kBlocksPerSM": "3"}, 3)}


def build_variants(out: Path) -> dict:
    """One library a variant of csrc/screen.cu (with csrc/sweep.cuh)."""
    src = (build.CSRC / "screen.cu").read_text()
    procs = {}
    for name, (consts, _) in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        text = src
        for key, val in consts.items():
            text = re.sub(rf"constexpr (\w+) {key} = [^;]+;", rf"constexpr \1 {key} = {val};",
                          text)
        (d / "screen.cu").write_text(text)
        (d / "sweep.cuh").write_text((build.CSRC / "sweep.cuh").read_text())
        nvcc = build._nvcc()
        cmd = (f"{nvcc} {' '.join(build.NVCC_FLAGS)} -c {d / 'screen.cu'} -o {d / 'screen.o'}"
               f" && {nvcc} -shared -o {d / 'lib.so'} {d / 'screen.o'}")
        procs[name] = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.screen_bounds_features.argtypes = build.SIGNATURES["screen_bounds_features"]
        lib.screen_bounds_features.restype = ctypes.c_int
        libs[name] = (lib, [ln.strip() for ln in text.splitlines()
                            if "registers" in ln or "spill stores" in ln])
    return libs


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="2048x10000,2048x19996,32768x4096,50000x10000")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    lib = build.library()
    variants = build_variants(ROOT / "build" / "screen_tune") if args.variants else {}
    res = {"script": "scripts/torch_screen_tune.py", "nvidia_smi": smi.stdout.strip(),
           "reps": args.reps, "shapes": [],
           "variants": {k: {"constants": VARIANTS[k][0], "blocks_per_sm": VARIANTS[k][1],
                            "ptxas": v[1]} for k, v in variants.items()}}
    sms = hinge.sm_count(torch.device("cuda", 0))
    for shape in args.shapes.split(","):
        m, n = (int(v) for v in shape.lower().split("x"))
        gen = torch.Generator(device="cuda").manual_seed(7)
        X = torch.randn(m, n, generator=gen, device="cuda")
        flat = torch.empty(m * n + 1, device="cuda")
        flat[1:] = X.reshape(-1)
        X_off = flat[1:].view(m, n)  # one item off a 16-byte boundary
        y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.6, 1.0, -1.0)
        theta = torch.rand(n, generator=gen, device="cuda") / 50.0
        scalars = screen.pack_shared(shared_scalars(y, 60.0, 40.0, theta, delta=1e-3))
        out = {"shape": [m, n], "bound_ms": m * n * 4 / HBM_BYTES_PER_S * 1e3,
               "choices": []}
        first = {}
        choices = CHOICES + [(screen.SCREEN_SEG_BYTES, VARIANTS[name][1], name)
                             for name in variants]
        for seg_bytes, per_sm, variant in choices:
            bulk = variant != "scalar"
            vlib = variants[variant][0] if variant in variants else lib
            segs = hinge._cdiv(n * 4, seg_bytes)
            seg = hinge._round_up(hinge._cdiv(n, segs), 4)
            part = torch.empty((4 * hinge._cdiv(n, seg), m), device="cuda")

            def call(Xc=X if bulk else X_off, seg=seg, grid=sms * per_sm, part=part,
                     bulk=bulk, vlib=vlib):
                bounds = torch.empty(m, device="cuda")
                dev, stream = build.stream_and_device(Xc)
                build.check(vlib.screen_bounds_features(
                    Xc.data_ptr(), 0, y.data_ptr(), theta.data_ptr(), None,
                    scalars.data_ptr(), m, n, int(bulk), grid, seg, part.data_ptr(),
                    bounds.data_ptr(), None, 0, dev, stream),
                    "screen_bounds_features")
                return bounds

            got = call()
            same = first.setdefault(seg_bytes, got)
            out["choices"].append({"seg_bytes": seg_bytes, "blocks_per_sm": per_sm,
                                   "variant": variant, "seg_cols": seg,
                                   "device_ms": device_ms(call, args.reps),
                                   "bitwise_first_of_split": bool(torch.equal(got, same))})
        sums = torch.randn(4, m, generator=gen, device="cuda").abs()

        def finalize():
            bounds = torch.empty(m, device="cuda")
            dev, stream = build.stream_and_device(sums)
            build.check(lib.screen_finalize_features(sums.data_ptr(), scalars.data_ptr(), m,
                                                     0, bounds.data_ptr(), dev, stream),
                        "screen_finalize_features")

        v = y * theta
        out["finalize_device_ms"] = device_ms(finalize, args.reps)
        out["torch_mv_device_ms"] = device_ms(lambda: torch.mv(X, v), args.reps)
        res["shapes"].append(out)
        del X, X_off, flat
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
