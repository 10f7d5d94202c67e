"""The launcher's grid host lane of two source trees, in turns on one card.

    python scripts/torch_grid_host_ab.py --old build/ab_parent/src [--turns 4]

``--old`` is the ``src`` directory of another checkout (e.g. ``git archive
<commit> src | tar -x -C build/ab_parent``); the other side is this
checkout's ``src``. Each turn is one run of that tree's launcher,
``python -m repro_torch.launch.train_svm --model 2 --data 2 --backend gloo
--device cuda`` on the full-width problem (``--m 50000 --n 10000``, seed 0,
fp32; ``--rules composite --n-lambdas 8 --lam-min-ratio 0.02`` by default),
in a fresh temporary working directory (the launcher's checkpoints and
``artifacts/`` stay there): the ranks share the card over gloo and run to
the launcher's stop rule. Turns: old, new, new, old, old, new, ... Prints
one JSON line per turn (rank 0's path wall, every rank's wall and
all-reduce calls, the launcher's path wall, the per-step objectives, kept
counts and iterations) and a last line with the walls, the medians, the
largest relative objective difference between the trees and the card's
name and power limit. Needs one CUDA GPU and nvcc.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STEP = re.compile(r"^step +(\d+) .* kept=(\d+) kept_samples=(\d+) .* obj=(\S+) iters=(\d+)")
RANK = re.compile(r"^rank (\d+) wall=(\S+)s allreduce_calls=(\d+)")
TOTAL = re.compile(r"^path wall (\S+)s")


def turn(src: str, args) -> dict:
    """One launcher run of the tree at ``src``; its walls and path."""
    argv = [sys.executable, "-m", "repro_torch.launch.train_svm", "--model", "2",
            "--data", "2", "--backend", "gloo", "--device", "cuda", "--m", str(args.m),
            "--n", str(args.n), "--rules", args.rules, "--n-lambdas", str(args.n_lambdas),
            "--lam-min-ratio", str(args.lam_min_ratio)]
    env = dict(os.environ, PYTHONPATH=src)
    with tempfile.TemporaryDirectory() as cwd:
        out = subprocess.run(argv, cwd=cwd, env=env, capture_output=True, text=True,
                             timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(f"{src}: exit {out.returncode}\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    steps, ranks, total = [], {}, None
    for line in out.stdout.splitlines():
        if m := STEP.match(line):
            steps.append([int(m[2]), int(m[3]), float(m[4]), int(m[5])])
        elif m := RANK.match(line):
            ranks[int(m[1])] = {"wall_s": float(m[2]), "allreduce_calls": int(m[3])}
        elif m := TOTAL.match(line):
            total = float(m[1])
    return {"src": src, "wall_s": ranks[0]["wall_s"], "ranks": ranks,
            "launcher_wall_s": total, "kept": [s[0] for s in steps],
            "kept_samples": [s[1] for s in steps],
            "objectives": [s[2] for s in steps], "iters": [s[3] for s in steps]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="src/ of the other tree")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--m", type=int, default=50_000)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--rules", default="composite")
    ap.add_argument("--n-lambdas", type=int, default=8)
    ap.add_argument("--lam-min-ratio", type=float, default=0.02)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_grid_host_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    old, new = str(Path(args.old).resolve()), str(ROOT / "src")
    turns = []
    for i in range(args.turns):
        turns.append(dict(turn((old, new, new, old)[i % 4], args),
                          side=("old", "new", "new", "old")[i % 4]))
        print(json.dumps(turns[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    objs = {s: np.array([t["objectives"] for t in turns if t["side"] == s])
            for s in ("old", "new")}
    print(json.dumps({
        "walls_s": {f"{i}:{t['side']}": t["wall_s"] for i, t in enumerate(turns)},
        "median_wall_s": {s: float(np.median([t["wall_s"] for t in turns
                                              if t["side"] == s])) for s in objs},
        "max_rel_obj_new_vs_old": float(np.max(np.abs(objs["new"] - objs["old"][0])
                                               / np.abs(objs["old"][0]))),
        "card": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
