"""The card's busy and idle shares over one full-width feature path, on the
host engine and on the scan engine.

    python scripts/torch_path_profile.py

Data: ``make_sparse_classification(m=50_000, n=10_000, density=1.0,
seed=0)``, fp32 on the card; the feature path (``feature_vi``, 8 lambdas,
lam_min_ratio 0.1): the host engine (gather) and the scan engine
(``reduce="compact"``). Each engine runs once to warm up (the scan engine
captures its chunk graphs there), once timed on the host clock, then once
under ``torch.profiler`` (CPU and CUDA activities) inside a
``record_function("path")`` span. Per engine: the span's length on the
profiler's clock, the union of the device's kernel, copy and set intervals
inside it (busy), the busy and idle shares of the span, the summed device
time over the unprofiled wall (the profiler's own host work stretches the
span), the kernel count, and the device time of the margin and
gradient kernels, and the 12 kernels that took the most device time;
beside them the time of one Lipschitz estimate, which both engines take
once per path. The profiler adds host work of its own, so the shares are
those of a profiled run. Prints one JSON line with the card's name and
power limit. Needs a CUDA GPU and nvcc.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core.path import svm_path  # noqa: E402
from repro_torch.core.solver import lipschitz_estimate  # noqa: E402
from repro_torch.data import make_sparse_classification  # noqa: E402


def union_us(intervals, lo, hi) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def profile_path(X, y, engine: str) -> dict:
    kw = dict(n_lambdas=8, lam_min_ratio=0.1, device="cuda")
    if engine == "scan":
        kw.update(engine="scan", reduce="compact")
    svm_path(X, y, **kw)  # warm-up (and the scan engine's captures)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svm_path(X, y, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("path"):
            res = svm_path(X, y, **kw)
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e for e in events if e.name == "path" and e.device_type == DeviceType.CPU)
    lo, hi = span.time_range.start, span.time_range.end
    # the device's kernels, copies and sets (not the span's own annotation)
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name != "path"]
    busy = union_us([(e.time_range.start, e.time_range.end) for e in dev], lo, hi)
    sweep_us = {k: sum(e.time_range.elapsed_us() for e in dev if k in e.name)
                for k in ("margin_partial", "hinge_grad")}
    by_name: dict = {}
    for e in dev:
        t = by_name.setdefault(e.name[:60], [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    device_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return {"span_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (hi - lo) if hi > lo else None,
            "idle_share": 1 - busy / (hi - lo) if hi > lo else None,
            "device_events": len(dev), "device_ms_summed": device_ms,
            "wall_ms_unprofiled": wall_ms,
            "busy_share_of_unprofiled_wall": device_ms / wall_ms,
            "sweep_ms": {k: v / 1e3 for k, v in sweep_us.items()},
            "top_kernels": [[k, n, us / 1e3] for k, (n, us) in top],
            "iters": int(res.solver_iters.sum())}


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = make_sparse_classification(m=50_000, n=10_000, density=1.0, seed=0)
    X, y = torch.from_numpy(ds.X).cuda(), torch.from_numpy(ds.y).cuda()
    del ds
    out = {"script": "torch_path_profile", "nvidia_smi": smi.stdout.strip(),
           "shape": list(X.shape)}
    # the path's Lipschitz estimate (100 power iterations, two GEMVs each),
    # which both engines take once per path
    lipschitz_estimate(X)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lipschitz_estimate(X)
    end.record()
    end.synchronize()
    out["lipschitz_ms"] = start.elapsed_time(end)
    for engine in ("host", "scan"):
        out[engine] = profile_path(X, y, engine)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
