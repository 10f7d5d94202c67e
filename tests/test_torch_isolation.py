"""The port stands alone: no JAX, no reference module, no silent CPU fallback."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    # each module as the first one of the package imported: an import
    # cycle shows only for some entry points
    for k in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
        del sys.modules[k]
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
if bad:
    sys.exit(f"loaded {bad}")
print(len(mods))
print("repro_torch.core.path_scan" in mods)
print(all(f"repro_torch.sparse.{m}" in mods
          for m in ("chunked", "screen_stream", "solver_stream")))
print("repro_torch.core.distributed" in mods)
print(all(m in mods for m in (
    "repro_torch.obs.trace", "repro_torch.obs.metrics", "repro_torch.obs.path_trace",
    "repro_torch.obs.log", "repro_torch.checkpoint.manager", "repro_torch.testing.faults")))
print("repro_torch.launch.path_server" in mods)
print(all(m in mods for m in (
    "repro_torch.configs", "repro_torch.models.transformer", "repro_torch.launch.serve",
    "repro_torch.core.paper_reference")))
print(all(f"repro_torch.models.{m}" in mods for m in ("mla", "moe", "ssm", "rglru")))
print(all(m in mods for m in ("repro_torch.models.sharding", "repro_torch.launch.mesh",
                              "repro_torch.launch.dryrun")))
import torch.distributed as dist
print(dist.is_available() and not dist.is_initialized())
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    # every submodule was imported, core/rules/dvi.py, core/path_scan.py,
    # the three modules of repro_torch.sparse, core/distributed.py, the
    # obs, checkpoint and testing packages, the path server, and the LM
    # scaffold (configs, models, the serving loop) and the paper's closed
    # forms among them, the other LM families' blocks (MLA, MoE, SSD,
    # RG-LRU), and the LM mesh, sharding rules and dry run; importing them
    # all started no process group
    (count, has_scan, has_sparse, has_dist, has_14a, has_server, has_lm, has_16b, has_16d,
     no_group) = out.stdout.split()[-10:]
    assert int(count) >= 69 and has_scan == "True" and has_sparse == "True"
    assert has_dist == "True" and has_14a == "True" and has_server == "True"
    assert has_lm == "True" and has_16b == "True" and has_16d == "True"
    assert no_group == "True"


def test_cuda_request_raises_without_gpu(monkeypatch):
    from repro_torch.core.path import PathDriver, svm_path
    from repro_torch.data import make_sparse_classification
    from repro_torch.launch import path_server
    from repro_torch.launch.train_svm import main
    from repro_torch.sparse import FeatureChunked

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_sparse_classification(m=20, n=10, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        svm_path(ds.X, ds.y, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        svm_path(ds.X, ds.y)  # the default device is the GPU
    with pytest.raises(RuntimeError, match="cuda"):
        svm_path(ds.X, ds.y, dynamic=True)
    with pytest.raises(RuntimeError, match="cuda"):
        svm_path(ds.X, ds.y, engine="scan")
    with pytest.raises(RuntimeError, match="cuda"):
        svm_path(ds.X, ds.y, engine="scan", reduce="compact", dynamic=True)
    with pytest.raises(RuntimeError, match="cuda"):
        svm_path(ds.X, ds.y, engine="batched", lambdas=[[2.0, 1.0]])
    with pytest.raises(RuntimeError, match="cuda"):
        PathDriver()
    with pytest.raises(RuntimeError, match="cuda"):
        PathDriver(dynamic=True)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--m", "20", "--n", "10"])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--m", "20", "--n", "10", "--dynamic", "--rules", "dvi"])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--m", "20", "--n", "10", "--engine", "scan"])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--m", "20", "--n", "10", "--engine", "batched"])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--m", "20", "--n", "10", "--model", "2", "--data", "2"])
    fc = FeatureChunked.from_dense(ds.X, chunk_m=8)
    with pytest.raises(RuntimeError, match="cuda"):
        svm_path(fc, ds.y)  # chunked storage runs on the GPU by default
    with pytest.raises(RuntimeError, match="cuda"):
        PathDriver(chunk_skip=False).run(fc, ds.y)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--m", "20", "--n", "10", "--storage", "chunked", "--chunk-m", "8"])
    with pytest.raises(RuntimeError, match="cuda"):
        path_server.PathServer()  # the server runs on the GPU by default
    with pytest.raises(RuntimeError, match="cuda"):
        path_server.main(["--jobs", "2", "--m", "20", "--n", "10"])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--serve", "--serve-jobs", "2", "--m", "20", "--n", "10"])


def test_unknown_rule_and_engine_fail_early():
    from repro_torch.core.path import svm_path
    from repro_torch.core.rules import make_rules

    # an unregistered name fails with the supported set in the message
    with pytest.raises(ValueError, match="feature_vi"):
        make_rules("no_such_rule")
    with pytest.raises(ValueError, match="host"):
        svm_path([[1.0]], [1.0], engine="no_such_engine", device="cpu")


def test_state_from_numpy_checks_dtypes_and_shapes():
    import numpy as np

    from repro_torch.convert import state_from_numpy

    X = np.zeros((4, 3), np.float32)
    ok = state_from_numpy({"X": X, "y": np.ones(3, np.float32),
                           "w": np.zeros(4, np.float32), "b": np.float32(0.5),
                           "L": np.float32(2.0),
                           "lambdas": np.array([2.0, 1.0])}, "cpu")
    assert ok["X"].shape == (4, 3) and ok["b"].dim() == 0
    assert ok["lambdas"].dtype == torch.float64
    with pytest.raises(TypeError):
        state_from_numpy({"X": X.astype(np.float64)}, "cpu")
    with pytest.raises(ValueError, match="length"):
        state_from_numpy({"X": X, "w": np.zeros(3, np.float32)}, "cpu")
    with pytest.raises(ValueError, match="rank"):
        state_from_numpy({"theta": X}, "cpu")
    with pytest.raises(ValueError, match="unknown"):
        state_from_numpy({"Z": X}, "cpu")


_TRAIN_PROBE = r"""
import importlib, sys
for name in ("repro_torch.data.tokens", "repro_torch.optim", "repro_torch.optim.adamw",
             "repro_torch.optim.schedule", "repro_torch.optim.compression",
             "repro_torch.launch.steps", "repro_torch.launch.train", "repro_torch.convert",
             "repro_torch.tree", "repro_torch.examples.train_lm",
             "repro_torch.examples.sparse_probe"):
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro" or k.startswith("repro."))
if bad:
    sys.exit(f"loaded {bad}")
print("ok")
"""


def test_training_modules_import_neither_jax_nor_reference():
    """The training slice's modules (the token pipeline, the optimizer, the
    train step and trainer, the tree walk, the examples), imported together in a fresh
    interpreter, load no JAX and nothing of ``repro``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", out.stdout + out.stderr


def test_host_mesh_raises_without_gpu(monkeypatch):
    """``make_host_mesh`` builds its mesh on the card by default and raises
    without one, before it starts a process group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_host_mesh()
    assert not dist.is_initialized()


def test_training_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """``train``, its ``main``, ``init_train_state`` and both examples run on
    the card by default and raise without one; ``device="cpu"`` is the only
    way to the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import sparse_probe, train_lm
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen2.5-3b")
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="cuda"):
        train_mod.train("qwen2.5-3b", steps=1, ckpt_dir=ck)
    with pytest.raises(RuntimeError, match="cuda"):
        train_mod.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "1", "--ckpt-dir", ck])
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        train_lm.main(["--steps", "1", "--ckpt-dir", ck])
    with pytest.raises(RuntimeError, match="cuda"):
        sparse_probe.main([])
    assert not (tmp_path / "ck").exists()  # nothing ran before the device check
