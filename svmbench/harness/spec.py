"""What a cell is, found by name.

``BENCHMARK.json`` at the checkout's root maps a cell to its configuration
and its traffic; the configuration's file holds the data's shape and the
name of its generator (``svmbench/gen/<generator>.py``), the traffic's
file (``svmbench/workloads/<traffic>.json``) the cross-validation loop,
the call into the port and the correctness limits; each metric's reader is
``svmbench/metrics/<metric>.py``. A new cell, configuration or metric is a
new file and a new entry: nothing here names one.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Metric:
    name: str
    unit: str
    reader: object  # the module ``svmbench.metrics.<name>``: ``read(run)``


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    def generator(self):
        """The module that makes this configuration's data."""
        return importlib.import_module(f"svmbench.gen.{self.config['generator']}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries: list, cell: str) -> list:
    out = []
    for e in entries:
        if "workloads" in e and cell not in e["workloads"]:
            continue
        reader = importlib.import_module(f"svmbench.metrics.{e['name']}")
        out.append(Metric(e["name"], e["unit"], reader))
    return out


def resolve(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read.
    Raises ``KeyError`` for a cell the benchmark does not hold."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "workloads" / f"{w['traffic']}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=_metrics(bench["end_to_end"], name),
                per_layer=_metrics(bench["per_layer"], name))
