"""The dry run's per-rank argument bytes as a markdown table.

    python scripts/torch_dryrun_table.py [artifacts/dryrun]

Reads the records ``python -m repro_torch.launch.dryrun --mesh both``
wrote (the production configuration, not ``--cost-mode`` or
``--baseline``) and prints one row an arch, one column a ``SHAPES`` entry:
each rank's argument bytes in GB (1e9 B) on (16, 16) / (2, 16, 16), a
``*`` where they exceed 80 GB (one H100's memory; arguments alone, no
activation or workspace), a ``†`` where that mesh's traced step did not
run (the record's ``step_error``), ``skip`` for a documented skip cell.
Then a second table of the same cells, each traced step's seconds on
(16, 16) / (2, 16, 16) (the record's ``step_s``: DTensor's dispatch and
planning on this CPU, no device's), and the count of records, skips and
steps that ran. The bytes are arithmetic of the placements, not a reading
of any device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("pod16x16", "pod2x16x16")
LIMIT = 80e9


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    d = Path(argv[0] if argv else "artifacts/dryrun")
    recs = {}
    for p in sorted(d.glob("*.json")):
        parts = p.stem.split("__")
        if len(parts) == 3:  # the production configuration only
            recs[tuple(parts)] = json.loads(p.read_text())
    archs = sorted({a for a, _, _ in recs})
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    ran = skips = 0
    for arch in archs:
        cells = []
        for shape in SHAPES:
            rs = [recs.get((arch, shape, m)) for m in MESHES]
            if any(r is None for r in rs):
                cells.append("missing")
                continue
            if "skipped" in rs[0]:
                skips += 2
                cells.append("skip")
                continue
            gb = []
            for r in rs:
                b = r["memory"]["argument_size_in_bytes"]
                stepped = r.get("collectives") is not None
                gb.append(f"{b / 1e9:.3g}" + ("*" if b > LIMIT else "") + ("" if stepped else "†"))
                ran += stepped
            cells.append(" / ".join(gb))
        print(f"| {arch} | " + " | ".join(cells) + " |")
    print("\n| arch | " + " | ".join(f"{sh} s" for sh in SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    for arch in archs:
        cells = []
        for shape in SHAPES:
            rs = [recs.get((arch, shape, m)) for m in MESHES]
            if any(r is None for r in rs):
                cells.append("missing")
            elif "skipped" in rs[0]:
                cells.append("skip")
            else:
                cells.append(" / ".join(f"{r['step_s']:.0f}" + ("" if r.get("collectives")
                                                                 is not None else "†")
                                        for r in rs))
        print(f"| {arch} | " + " | ".join(cells) + " |")
    print(f"\n{len(recs)} records, {skips} skips, {ran} traced steps ran")
    return 0


if __name__ == "__main__":
    sys.exit(main())
