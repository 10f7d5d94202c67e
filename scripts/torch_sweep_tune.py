"""Time the port's persistent sweeps (the column sweep of the margin and of
the sample surplus, and the gradient) under several choices of their
launch-plan constants, in one process on one GPU, beside the PyTorch call
that reads the same bytes.

    python scripts/torch_sweep_tune.py

Each choice sets the constants of ``kernels/hinge.py`` (for the column
sweep: ``COLUMN_UNITS``, ``COLUMN_STAGE_BYTES``, ``COLUMN_STAGES``,
``COLUMN_SEG_ALIGN``; for the gradient: ``GRAD_STAGE_BYTES``,
``GRAD_STAGES``), checks the kernel against its plain version, and times
it (CUDA events, mean of 30 calls). The column sweep's choices are timed
for the margin (all rows live; ``torch.mv(X.t(), w)`` beside it) and for
the sample surplus (``torch.mv(X.t(), w1)``). The first choice of each list
is repeated last, to show the drift within the run. X is fp32 (and, for
the column sweep, bf16) 50,000 x 10,000 from a seeded CUDA generator. Prints
one JSON line a choice and the card's name and power limit. Needs a CUDA
GPU and nvcc.
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import build, hinge, screen  # noqa: E402

# (COLUMN_UNITS, COLUMN_STAGE_BYTES, COLUMN_STAGES, COLUMN_SEG_ALIGN)
COLUMN = [(1, 32768, 4, 16), (2, 32768, 4, 16), (4, 32768, 4, 16),
          (4, 49152, 4, 16), (4, 49152, 4, 128), (4, 65536, 3, 128),
          (4, 32768, 6, 128),
          (1, 32768, 4, 16)]
# (GRAD_STAGE_BYTES, GRAD_STAGES)
GRAD = [(32768, 4), (8192, 8), (16384, 6), (49152, 4), (32768, 4)]


def timed_ms(fn, reps=30):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    saved = {k: getattr(hinge, k) for k in (
        "COLUMN_UNITS", "COLUMN_STAGE_BYTES", "COLUMN_STAGES", "COLUMN_SEG_ALIGN",
        "GRAD_STAGE_BYTES", "GRAD_STAGES")}
    g = torch.Generator(device="cuda").manual_seed(0)
    m, n = 50_000, 10_000
    X = torch.randn(m, n, device="cuda", generator=g)
    y = torch.where(torch.rand(n, device="cuda", generator=g) < 0.5, 1.0, -1.0)
    xi = torch.rand(n, device="cuda", generator=g)
    w1 = torch.randn(m, device="cuda", generator=g) * 0.01
    u_prev = torch.randn(n, device="cuda", generator=g)
    v = y * xi
    sms = hinge.sm_count(X.device)
    b = torch.tensor(0.1, device="cuda")
    for Xd in (X, X.to(torch.bfloat16)):
        lib = timed_ms(lambda: torch.mv(Xd.t(), w1.to(Xd.dtype)))
        sweeps = (
            ("margin_obj", (Xd, w1, y, b), hinge.margin_obj_op, hinge.margin_obj_plain),
            ("sample_surplus", (Xd, w1, y, 0.1, 0.3, 0.02, u_prev),
             screen.sample_surplus_op, screen.sample_surplus_plain))
        for name, args, op, plain in sweeps:
            want = plain(*args)
            for cfg in COLUMN:
                (hinge.COLUMN_UNITS, hinge.COLUMN_STAGE_BYTES, hinge.COLUMN_STAGES,
                 hinge.COLUMN_SEG_ALIGN) = cfg
                hinge.column_sweep_plan.cache_clear()
                plan = hinge.column_sweep_plan(m, n, Xd.element_size(), True, sms)
                err = max_err(op(*args), want)
                print(json.dumps({
                    "kernel": name, "dtype": str(Xd.dtype), "choice": cfg,
                    "plan": plan._asdict(), "smem_bytes": plan.smem_bytes,
                    "max_abs_err": err, "ms": timed_ms(lambda: op(*args)),
                    "library_ms": lib}), flush=True)
    want = hinge.hinge_grad_plain(X, y, xi)
    lib = timed_ms(lambda: torch.mv(X, v))
    for cfg in GRAD:
        hinge.GRAD_STAGE_BYTES, hinge.GRAD_STAGES = cfg
        hinge.grad_plan.cache_clear()
        plan = hinge.grad_plan(m, n, 4, True, sms)
        err = float((hinge.hinge_grad_op(X, y, xi) - want).abs().max())
        print(json.dumps({
            "kernel": "hinge_grad", "dtype": "torch.float32", "choice": cfg,
            "plan": plan._asdict(), "smem_bytes": plan.smem_bytes, "max_abs_err": err,
            "ms": timed_ms(lambda: hinge.hinge_grad_op(X, y, xi)), "library_ms": lib}),
            flush=True)
    for k, val in saved.items():
        setattr(hinge, k, val)
    hinge.column_sweep_plan.cache_clear()
    hinge.grad_plan.cache_clear()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0]
                      if smi.returncode == 0 else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
