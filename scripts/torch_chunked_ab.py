"""Time the news20-shaped out-of-core path of an earlier tree against the
current one, on one GPU, in turns (old, new, new, old).

    python scripts/torch_chunked_ab.py --old build/ab_parent

``--old`` is an unpacked earlier tree (``git archive <commit> | tar -x -C
build/ab_parent``). Each turn is a process of its own that imports that
tree's ``chip_smoke.py`` and ``src/`` and runs its ``chunked_sparse_path``
phase: the news20.binary-shaped CSR instance (seed 0) saved to a memmap
store, the feature path over 662 chunks of 2,048 rows, then its no-skip
twin, with every check of the phase. Each tree builds its kernels in its
own ``build/kernels``. Prints one JSON line: the card's name and power
limit, and per turn the path's and the twin's walls and the parts' walls
(``screen_s``, ``certify_s``, ...) summed over the steps. Needs a CUDA GPU
and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = """
import json, sys
sys.path.insert(0, {tree!r})
sys.path.insert(0, {tree!r} + "/src")
import torch
import chip_smoke as cs
from repro_torch.core.dual import theta_at_lambda_max
from repro_torch.core.path import PathDriver
from repro_torch.core.screening import shared_scalars
from repro_torch.kernels import ops, screen
import repro_torch.sparse as sparse
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_chunked_sparse_path(PathDriver, ops, sparse, screen, shared_scalars,
                             theta_at_lambda_max)
"""


def turn(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", TURN.format(tree=str(tree.resolve()))],
                         capture_output=True, text=True, cwd=tree)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: exit {out.returncode}\n{out.stderr[-3000:]}")
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith('{"phase": "chunked_sparse_path"'))
    d = json.loads(line)
    return {"tree": str(tree), "path_s": d["path_s"], "twin_s": d["twin_s"],
            "parts_s": {k: sum(v) for k, v in d["part_walls_s"].items()},
            "screen_launches": d["screen_launches"],
            "screen_device_ms_per_chunk": d.get("screen_device_ms_per_chunk"),
            "screen_ms_per_chunk": d["screen_ms_per_chunk"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True)
    args = ap.parse_args()
    new = Path(__file__).resolve().parents[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    res = {"script": "scripts/torch_chunked_ab.py", "nvidia_smi": smi.stdout.strip(),
           "order": "old, new, new, old",
           "turns": [turn(t) for t in (args.old, new, new, args.old)]}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
