"""How a train step takes the gradients of a segment's stacked parameters,
timed on the card.

    python scripts/torch_train_grad_layout.py [--layers 36] [--turns 2]

``models/transformer.py`` unbinds each stacked leaf once a segment
(``_units``): every unit's parameters are views, and autograd stacks their
gradients back into one tensor a leaf. The alternative slices each unit
out of the stack (``t[u]``), whose backward writes a zero tensor the size of
the whole stack for every unit (qwen2.5-3b's stacked MLP ``wi`` is 36 x
2,048 x 11,008 float32, 3.25 GB). This script runs qwen2.5-3b's published
widths (bf16 over float32 masters, ``remat="full"``) on ``--layers`` layers,
one loss and gradient at 4 x 1,024 tokens a run, the two layouts in turns
(unbind, slice, slice, unbind, ...), and prints each run's ms (CUDA events),
peak memory and the largest difference of the two layouts' gradients, then
the card's name and power limit.

One-off evidence for the layout ``_units`` keeps (its readings are in
PERF.md): the next change of that layout may delete this script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.tree import tree_keys  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def sliced_units(tree, n):
    """One slice a unit (``t[u]``), the layout the port does not use."""
    return [tree_map(lambda t: t[u], tree) for u in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=36)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2.5-3b").replace(num_layers=args.layers)
    params = tr.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    wi = list(tree_keys(params)).index("segments/0/s0/mlp/wi")  # its gradient's index
    b = TokenPipeline(cfg.vocab_size, args.batch, args.seq).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    layouts = {"unbind": tr._units, "slice": sliced_units}
    kept, runs = {}, []  # the stacked MLP wi's gradient of each layout, for the difference
    order = ["unbind", "slice", "slice", "unbind"] * args.turns
    for name in ["unbind"] + order:  # the first run warms the libraries up
        tr._units = layouts[name]
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            _, _, g = steps._value_and_grads(cfg, params, batch)
            end.record()
            end.synchronize()
        finally:
            tr._units = layouts["unbind"]
        # the run's own peak: above the parameters and what earlier runs keep
        runs.append({"layout": name, "ms": start.elapsed_time(end),
                     "peak_gbytes": (torch.cuda.max_memory_allocated() - base) / 1e9})
        if name not in kept:
            kept[name] = g[wi].clone()
        del g
    diff = float((kept["unbind"] - kept["slice"]).abs().max())
    med = {k: float(np.median([r["ms"] for r in runs[1:] if r["layout"] == k]))
           for k in layouts}
    for r in runs[1:]:
        print(json.dumps(r), flush=True)
    print(json.dumps({"layers": args.layers, "batch": args.batch, "seq": args.seq,
                      "median_ms": med, "peak_gbytes": {
                          k: max(r["peak_gbytes"] for r in runs[1:] if r["layout"] == k)
                          for k in layouts}, "max_abs_grad_diff": diff}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
