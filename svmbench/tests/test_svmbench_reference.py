"""The float64 reference: its own path meets the optimality conditions, its
judge flags a discarded active feature, and nothing under ``svmbench/``
imports JAX or the JAX package (nor, under ``reference/``, the port)."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from svmbench.gen import text_like
from svmbench.reference import svm64

BENCH = Path(__file__).resolve().parents[1]
FIXTURE = BENCH / "tests" / "fixtures" / "tiny_text.json"


@pytest.fixture(scope="module")
def instance():
    torch.set_num_threads(2)
    X, y = text_like.make(json.loads(FIXTURE.read_text()), 2 ** 31 + 11, "cpu")
    y64 = y.double()
    lam_max = float(torch.max(torch.abs(X.double() @ (y64 - y64.mean()))))
    lams = np.geomspace(lam_max, 0.3 * lam_max, 6)
    return X, y, lam_max, lams, svm64.solve_path(X, y, lams, tol=1e-9)


def as_path(lams, sol, lam_max, keep):
    return {"lambdas": lams, "weights": sol["weights"], "biases": sol["biases"],
            "objectives": sol["objectives"], "keep_masks": keep, "sample_masks": {},
            "deltas": np.zeros(len(lams)), "lam_max": lam_max}


def test_float64_path_meets_kkt(instance):
    X, y, lam_max, lams, sol = instance
    assert X.shape == (2000, 400)
    keep = np.ones((len(lams), X.shape[0]), bool)
    r = svm64.judge(X, y, as_path(lams, sol, lam_max, keep))
    assert np.max(r["kkt_rel"]) <= 1e-8
    assert np.max(r["gap_rel"]) <= 1e-6
    assert np.max(r["obj_rel"]) <= 1e-12
    assert r["lam_max_rel"] <= 1e-14
    assert np.count_nonzero(sol["weights"][-1]) > 3


def test_judge_flags_a_discarded_active_feature(instance):
    X, y, lam_max, lams, sol = instance
    k = len(lams) - 1
    j = int(np.argmax(np.abs(sol["weights"][k])))
    Xr = X.clone()
    Xr[j] = 0.0  # the step solved without feature j, as a wrong screen leaves it
    red = svm64.solve_path(Xr, y, lams[k:], tol=1e-9)
    bad = {name: v.copy() for name, v in sol.items()}
    for name in bad:
        bad[name][k] = red[name][0]
    keep = np.ones((len(lams), X.shape[0]), bool)
    keep[k, j] = False
    r = svm64.judge(X, y, as_path(lams, bad, lam_max, keep))
    assert r["screen_ratio"][k] > 1.05
    assert r["kkt_rel"][k] > 0.05
    assert np.max(r["screen_ratio"][:k]) == 0.0


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


def test_no_jax_and_a_reference_of_its_own():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        found = _imports(f) & {"jax", "jaxlib", "flax", "repro"}
        assert not found, f"{f} imports {found}"
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in _imports(f), f"{f} imports the port"


def test_import_scan_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom jax.numpy import ones\nimport reprox\n")
    assert _imports(f) == {"repro_torch", "jax", "reprox"}


def test_cert_factor_reads_how_many_times_too_short_a_radius_is(instance):
    X, y, lam_max, lams, sol = instance
    keep = np.ones((len(lams), X.shape[0]), bool)
    path = as_path(lams, sol, lam_max, keep)
    path["deltas"] = np.full(len(lams), np.inf)
    assert np.all(svm64.judge(X, y, path)["cert_factor"] == 0.0)  # covered
    # a radius the float64 certificate reaches: the float64 one itself
    path["deltas"] = np.full(len(lams), 1e-30)
    radius = svm64.judge(X, y, path)["cert_factor"] * 1e-30
    assert np.all(radius[1:] > 0)
    path["deltas"] = radius.copy()
    assert np.allclose(svm64.judge(X, y, path)["cert_factor"][1:], 1.0)
    path["deltas"] = radius / 1000.0  # collapsed by 1000 times
    assert np.allclose(svm64.judge(X, y, path)["cert_factor"][1:], 1000.0)
    # a radius of 0: exact for w = 0 at lambda_max, never for a w != 0
    path["deltas"] = np.zeros(len(lams))
    path["weights"] = sol["weights"].copy()
    path["weights"][0] = 0.0
    r = svm64.judge(X, y, path)["cert_factor"]
    assert r[0] == 0.0 and np.all(np.isinf(r[1:]))
