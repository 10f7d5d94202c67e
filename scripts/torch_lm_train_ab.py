"""A/B of the LM train step on the card: ``chip_smoke.phase_lm_train``
(qwen2.5-3b at full width, 8 steps of 4 x 1,024 tokens, the median of
steps 2-7) of two trees in turns, A B B A, each run in a process of its
own.

    python scripts/torch_lm_train_ab.py <tree A> <tree B>

A tree is a checkout's root (``git archive <commit>`` unpacked). Prints the
card's name and power limit, one JSON line a run (the tree, its median step
ms, the bound share, the profiled step's busy share and the update's
device ms), and last the medians of each tree's two runs.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

CHILD = """
import sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from repro_torch import configs
from repro_torch.launch import steps
cs.phase_lm_train(configs, steps)
"""


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=root)], cwd=root,
                         capture_output=True, text=True, check=True).stdout
    rec = next(json.loads(ln) for ln in out.splitlines()
               if ln.startswith("{") and '"phase": "lm_train"' in ln)
    return {"tree": root, "step_ms": rec["step_ms"], "bound_share": rec["bound_share"],
            "busy_share": rec["profile"]["busy_share"],
            "update_device_ms": rec["profile"]["update_device_ms"]}


def main(argv=None) -> int:
    a, b = sys.argv[1:] if argv is None else argv
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    runs = []
    for root in (a, b, b, a):
        runs.append(run(root))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({root: statistics.median(r["step_ms"] for r in runs if r["tree"] == root)
                      for root in (a, b)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
