"""The harness end to end on the CPU, in a copy of the checkout that holds
``BENCHMARK.json`` and ``svmbench/`` with a test-only cell at 2,000 x 400
(``fixtures/tiny_text.json``) on each traffic: the last line's keys, a cell
dropped in as files with no code edit, the lower-precision control, the
planted faults and the host engine's unfloored certificate read ``correct:
false``, no result without CUDA or without the port."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
SRC = REPO / "src"
TRAFFIC = ("cv5.host_vi", "cv5.scan_vi", "cv5.host_sifs")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def make_checkout(root: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "svmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH / "tests" / "fixtures" / "tiny_text.json",
                root / "svmbench" / "configs" / "tiny_text.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_text", "source": "test fixture",
                         "file": "svmbench/configs/tiny_text.json", "reduced": [],
                         "why": "test"})
    for t in TRAFFIC:
        b["workloads"].append({"name": f"tiny.{t.split('.')[1]}", "config": "tiny_text",
                               "traffic": t, "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"))


def run(root: Path, *args, src=True, script=("svmbench/run.py",)):
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    if src:
        env["PYTHONPATH"] = str(SRC)
    p = subprocess.run([sys.executable, *script, *args], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else None
    return p, (json.loads(last) if last else None)


def cpu(cell, *extra, seconds="2"):
    return ("--workload", cell, "--seed", str(2 ** 31 + 9), "--seconds", seconds,
            "--device", "cpu", *extra)


def test_last_line_holds_the_result(checkout):
    p, out = run(checkout, *cpu("tiny.scan_vi"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"paths_per_s", "setup_s"}  # no peak off the card
    assert out["device"]["platform"] == "cpu"
    checks = out["checks"]
    assert set(checks) >= {"lam_max_rel", "obj_rel", "kkt_rel", "cert_factor"}
    # the window's paths and the fold the seed draws are judged
    assert f"check: {out['attempted'] + 1} paths judged" in p.stderr
    tail = p.stderr.strip().splitlines()[-len(checks):]
    assert [line.split()[1] for line in tail] == list(checks)


def add_short_cell(root: Path, traffic: str, cell: str) -> None:
    """A cell on a short traffic: 2 folds, 5 lambdas to 0.3 (the CPU's
    profiler makes a path slow)."""
    t = json.loads((root / f"svmbench/workloads/{traffic}.json").read_text())
    t.update(folds=2, n_lambdas=5, lam_min_ratio=0.3)
    (root / f"svmbench/workloads/{cell}.json").write_text(json.dumps(t))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": cell, "config": "tiny_text", "traffic": cell,
                           "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def test_traced_run_reports_the_per_layer_metrics(tmp_path):
    root = make_checkout(tmp_path)
    add_short_cell(root, "cv5.scan_vi", "tiny.short_scan")
    p, out = run(root, *cpu("tiny.short_scan", "--trace", "1", seconds="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert out["correct"] is True
    # no device trace on the CPU: the device readers find nothing to read
    assert set(out["metrics"]) == {"kept_share", "iters_per_path", "iter_ms"}


def test_a_new_cell_is_taken_from_files_alone(tmp_path):
    root = make_checkout(tmp_path)
    add_short_cell(root, "cv5.scan_vi", "tiny.short")
    p, out = run(root, *cpu("tiny.short", seconds="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert out["correct"] is True
    assert out["attempted"] >= 2 and out["attempted"] % 2 == 0  # whole cycles of 2 folds


@pytest.mark.parametrize("cell", ["tiny.host_vi", "tiny.scan_vi", "tiny.host_sifs"])
def test_the_control_is_not_correct(checkout, cell):
    p, out = run(checkout, *cpu(cell, "--control", "bf16", seconds="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert out["correct"] is False
    assert out["checks"]["lam_max_rel"]["value"] > out["checks"]["lam_max_rel"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["tiny.host_vi", "tiny.scan_vi"])
def test_a_broken_solve_is_not_correct(checkout, cell, fault):
    script = (str(BENCH / "tests" / "_faulty_run.py"), fault)
    p, out = run(checkout, *cpu(cell, seconds="1"), script=script)
    assert p.returncode == 0, p.stderr[-3000:]
    assert out["correct"] is False
    # a number of the solve fails, not only the host engine's certificate
    assert any(not c["value"] <= c["limit"] for k, c in out["checks"].items()
               if k != "cert_factor")


def test_the_host_engines_unfloored_certificate_is_not_correct(checkout):
    # the host engine takes its certificate's gap in fp32 with no floor: its
    # radius collapses near lambda_max, and only cert_factor shows it here
    p, out = run(checkout, *cpu("tiny.host_vi", seconds="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert out["correct"] is False and out["failed"] == 0
    bad = {k for k, c in out["checks"].items() if not c["value"] <= c["limit"]}
    assert bad == {"cert_factor"}


def test_no_result_without_cuda(checkout):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    p, out = run(checkout, "--workload", "tiny.host_vi", "--seed", "1", "--seconds", "1")
    assert p.returncode == 2 and out is None


def test_no_result_without_the_port(checkout):
    p, out = run(checkout, *cpu("tiny.host_vi", seconds="1"), src=False)
    assert p.returncode != 0 and out is None


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    from svmbench import run as harness

    for name in ("repro_torch", "repro_torch.core", "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax", "repro"]
