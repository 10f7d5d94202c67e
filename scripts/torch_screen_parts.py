"""Time the feature-screen kernel with parts of its work taken out, to see
where its time goes, in one process on one GPU.

    python scripts/torch_screen_parts.py

Builds copies of ``kernels/csrc/screen.cu`` under ``build/screen_parts/``
(the package's ``nvcc`` flags, all at once), each with one patch of
``PATCHES``: ``as_built``; ``unstaged``, which stages no columns and reads
theta and y from global memory in their place; ``sweep_only``, which skips
the finalize kernel; both; and ``stage_unroll_8``, the staging loop
unrolled 8 deep. The variants other than ``as_built`` and
``stage_unroll_8`` are for timing only: their bounds are not the screen's.
Each runs the VI mode (fp32 X from a seeded CUDA generator) at 2,048 x
10,000, 2,048 x 19,996 and 50,000 x 10,000, timed twice by its device time
(50 calls captured in one CUDA graph, one replay timed with CUDA events,
over 50), beside ``torch.mv(X, y theta1)``. Prints one JSON line with the
card's name and power limit. Needs a CUDA GPU and nvcc.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))
from repro_torch.core.screening import shared_scalars  # noqa: E402
from repro_torch.kernels import build, hinge, screen  # noqa: E402
from torch_screen_tune import device_ms  # noqa: E402

NO_STAGING = [("for (int j = threadIdx.x; j < padded; j += kThreads) {",
               "for (int j = threadIdx.x; j < 0; j += kThreads) {"),
              ("cols, v,\n", "cols, Staged{theta + c0, y + c0, (w != nullptr ? w : y) + c0},\n")]
NO_FINALIZE = [("if (err != cudaSuccess || p.segs == 1) return err;", "return err;")]
PATCHES = {"as_built": [], "unstaged": NO_STAGING,
           "stage_unroll_8": [("#pragma unroll 4\n    for (int j = threadIdx.x;",
                               "#pragma unroll 8\n    for (int j = threadIdx.x;")],
           "sweep_only": NO_FINALIZE, "unstaged_sweep_only": NO_STAGING + NO_FINALIZE}
SHAPES = ((2048, 10000), (2048, 19996), (50000, 10000))


def build_patched(out: Path) -> dict:
    src = (build.CSRC / "screen.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name, patches in PATCHES.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch does not fit csrc/screen.cu: {old!r}")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "screen.cu").write_text(text)
        (d / "sweep.cuh").write_text((build.CSRC / "sweep.cuh").read_text())
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
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    libs = build_patched(ROOT / "build" / "screen_parts")
    res = {"script": "scripts/torch_screen_parts.py", "nvidia_smi": smi.stdout.strip()}
    sms = hinge.sm_count(torch.device("cuda", 0))
    for m, n in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(7)
        X = torch.randn(m, n, generator=gen, device="cuda")
        y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.6, 1.0, -1.0)
        theta = torch.rand(n, generator=gen, device="cuda") / 50.0
        scalars = screen.pack_shared(shared_scalars(y, 60.0, 40.0, theta, delta=1e-3))
        plan = screen.screen_plan(m, n, 4, True, sms)
        part = torch.empty(plan.scratch_shape(), device="cuda")
        row = {}
        for _ in range(2):
            for name, lib in libs.items():
                def call(lib=lib):
                    bounds = torch.empty(m, device="cuda")
                    dev, stream = build.stream_and_device(X)
                    build.check(lib.screen_bounds_features(
                        X.data_ptr(), 0, y.data_ptr(), theta.data_ptr(), None,
                        scalars.data_ptr(), m, n, 1, plan.grid, plan.seg_cols,
                        part.data_ptr(), bounds.data_ptr(), None, 0, dev, stream),
                        "screen_bounds_features")
                row.setdefault(name, []).append(device_ms(call, 50))
        v = y * theta
        row["torch_mv"] = [device_ms(lambda: torch.mv(X, v), 50)]
        res[f"{m}x{n}"] = row
        del X
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
