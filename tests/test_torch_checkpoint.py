"""The port's checkpoints (``repro_torch/checkpoint/manager.py``) and the
host path's resume (``PathDriver(ckpt_dir=)``, the launcher's
``--ckpt-dir``), against the reference's manager and path.

Inputs: ``make_sparse_classification(m=120, n=60, seed=21)`` made with numpy.
Paths run at fixed iterations (``tol = -1``) on the port's L. Tolerances:

* the manager: arrays bit for bit, dtypes kept, the manifest's ``extra``
  as JSON round-trips it; each package's ``restore_raw`` reads the other's
  checkpoint bit for bit;
* a resumed ``feature_vi`` or ``dvi`` path (interrupted after step 3): the
  uninterrupted path's weights, objectives, keep masks and certificates bit
  for bit;
* a resumed ``composite`` path: its sample rule's secant history starts
  empty, as in the reference, so objectives within rel 1e-5 of the
  uninterrupted path and no screened sample with slack in float64;
* a ``2 x 2`` checkpoint resumed on one device: steps before the resume as
  the grid saved them, objectives within rel 1e-5 of the uninterrupted
  single-device path, no feature screened that the unscreened path uses;
* the reference's ``PathDriver`` on the same path: objectives within rel
  1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_ranks import interrupted_path
from repro.checkpoint import CheckpointManager as RefManager
from repro.core.path import PathDriver as RefDriver
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.core import distributed as D
from repro_torch.core.path import PathDriver
from repro_torch.core.solver import lipschitz_estimate
from repro_torch.data import make_sparse_classification
from repro_torch.launch.train_svm import main as train_main

PATH = dict(n_lambdas=6, lam_min_ratio=0.1)
FIXED = dict(tol=-1.0, max_iters=60)
STOP = 4  # the interrupted run stops in step 4: steps 1-3 are saved


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return make_sparse_classification(m=120, n=60, seed=21)


@pytest.fixture(scope="module")
def L(ds):
    return float(lipschitz_estimate(torch.from_numpy(ds.X)))


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g), "b": torch.zeros((4,))},
            "opt": {"mu": torch.ones((8, 4)), "step": torch.tensor(7, dtype=torch.int32)},
            "hist": [np.arange(3.0), np.float32(0.5)]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# -- the manager (tests/test_checkpoint.py, without the server) ----------------


def test_roundtrip(tmp_path):
    s = _state()
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, s, extra={"next_step": 6})
    assert mgr.latest() == 5
    template = {"params": {"w": torch.zeros((8, 4)), "b": torch.zeros((4,))},
                "opt": {"mu": torch.zeros((8, 4)), "step": torch.tensor(0, dtype=torch.int32)},
                "hist": [np.zeros(3), np.float32(0.0)]}
    restored, manifest = mgr.restore(5, template)
    assert manifest["extra"]["next_step"] == 6
    for a, b in zip(_leaves(s), _leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert restored["opt"]["step"].dtype == torch.int32


def test_bf16_leaves_round_trip_and_read_the_reference(tmp_path):
    """A bf16 leaf (numpy has none) is written as its 2-byte values and comes
    back bit for bit, or cast to a float32 template; the port reads the
    reference's own bf16 checkpoint the same way, while the reference's
    ``restore`` refuses both (``ValueError``, its own format included)."""
    vals = torch.tensor([1.5, -2.25, 3.0, float("inf"), -0.0, 1e-40], dtype=torch.bfloat16)
    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(1, {"m": vals, "w": torch.ones(3)})
    back, _ = mgr.restore(1, {"m": torch.zeros(6, dtype=torch.bfloat16), "w": torch.zeros(3)})
    assert back["m"].dtype == torch.bfloat16
    assert torch.equal(back["m"].view(torch.int16), vals.view(torch.int16))
    as32, _ = mgr.restore(1, {"m": torch.zeros(6), "w": torch.zeros(3)})
    assert torch.equal(as32["m"], vals.float())

    ref = RefManager(tmp_path / "ref")
    ref.save(1, {"m": jnp.asarray(vals.float().numpy(), jnp.bfloat16)})
    from_ref, _ = CheckpointManager(tmp_path / "ref").restore(
        1, {"m": torch.zeros(6, dtype=torch.bfloat16)})
    assert torch.equal(from_ref["m"].view(torch.int16), vals.view(torch.int16))
    for d in ("port", "ref"):
        with pytest.raises(ValueError):
            RefManager(tmp_path / d).restore(1, {"m": jnp.zeros(6, jnp.bfloat16)})


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == [3, 4]


def test_corrupt_latest_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    (tmp_path / "step_000000000002" / "manifest.json").write_text("{broken")
    assert mgr.latest() == 1


def test_elastic_restore_dtype_cast(tmp_path):
    """A restart may restore into another dtype (the template's)."""
    s = _state()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, s)
    template = {"params": {"w": torch.zeros((8, 4), dtype=torch.bfloat16),
                           "b": torch.zeros((4,))}}
    restored, _ = mgr.restore(1, template)
    assert restored["params"]["w"].dtype == torch.bfloat16
    with pytest.raises(KeyError):
        mgr.restore(1, {"absent": torch.zeros(2)})
    kept, _ = mgr.restore(1, {"absent": torch.ones(2)}, strict=False)
    np.testing.assert_array_equal(kept["absent"].numpy(), np.ones(2))


def test_atomicity_no_tmp_left(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(9, _state())
    assert not list(tmp_path.glob("*.tmp"))
    save_pytree({"a": torch.arange(3)}, tmp_path / "x.npz")
    assert load_pytree({"a": torch.zeros(3, dtype=torch.int64)},
                       tmp_path / "x.npz")["a"].tolist() == [0, 1, 2]


def test_restore_raw_roundtrip(tmp_path):
    flat = {"carry0": np.arange(12, dtype=np.float32).reshape(3, 4),
            "job0_lambdas": np.array([0.5, 0.25], dtype=np.float64),
            "act": np.array([True, False])}
    extra = {"slots": [0, -1], "pending": [1, 2],
             "jobs": {"0": {"t": 2, "status": "running"}}}
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(3, flat, extra=extra)
    got, manifest = mgr.restore_raw(3)
    assert set(got) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])
        assert got[k].dtype == flat[k].dtype
    assert manifest["extra"] == json.loads(json.dumps(extra))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_restore_raw_reads_the_other_package(tmp_path, writer):
    """The same state saved by either package: the same keys (``||``
    separated paths) and bits, and the other package's ``restore_raw`` (and
    ``restore`` into its own template) reads it."""
    rng = np.random.default_rng(5)
    arrays = {"w": rng.standard_normal(7).astype(np.float32),
              "theta": rng.standard_normal(5).astype(np.float32),
              "k": np.int32(3),
              "record": {"weights": rng.standard_normal((2, 7)).astype(np.float32)}}
    extra = {"next_k": 4, "lambdas": [2.0, 1.0]}
    if writer == "reference":
        RefManager(tmp_path).save(3, jax.tree_util.tree_map(jnp.asarray, arrays),
                                  extra=extra)
        flat, manifest = CheckpointManager(tmp_path).restore_raw(3)
        state, _ = CheckpointManager(tmp_path).restore(
            3, {"w": torch.zeros(7), "k": torch.tensor(0, dtype=torch.int32)})
        np.testing.assert_array_equal(state["w"].numpy(), arrays["w"])
    else:
        CheckpointManager(tmp_path).save(
            3, {k: torch.from_numpy(np.asarray(v)) if k == "w" else v
                for k, v in arrays.items()}, extra=extra)
        flat, manifest = RefManager(tmp_path).restore_raw(3)
        state, _ = RefManager(tmp_path).restore(
            3, {"w": jnp.zeros(7, jnp.float32), "k": jnp.asarray(0, jnp.int32)})
        np.testing.assert_array_equal(np.asarray(state["w"]), arrays["w"])
    assert set(flat) == {"w", "theta", "k", "record||weights"}
    np.testing.assert_array_equal(flat["w"], arrays["w"])
    np.testing.assert_array_equal(flat["record||weights"], arrays["record"]["weights"])
    assert flat["w"].dtype == np.float32 and int(flat["k"]) == 3
    assert manifest["extra"] == extra and manifest["step"] == 3


# -- resuming a path ---------------------------------------------------------------


class _Stop(RuntimeError):
    pass


def _stop_at(k):
    def injector(step, w, b):
        if step == k:
            raise _Stop(step)
        return w, b
    return injector


def _driver(rules, L, reduce="gather", **kw):
    return PathDriver(rules, reduce=reduce, L=L, device="cpu", **FIXED, **kw)


def _interrupted_then_resumed(ds, L, rules, reduce, ckpt):
    drv = _driver(rules, L, reduce, ckpt_dir=ckpt)
    drv._fault_injector = _stop_at(STOP)
    with pytest.raises(_Stop):
        drv.run(ds.X, ds.y, **PATH)
    res = _driver(rules, L, reduce, ckpt_dir=ckpt).run(ds.X, ds.y, **PATH)
    assert res.extras["checkpoint"]["resumed_at"] == STOP
    return res


@pytest.mark.parametrize("rules,reduce", [("feature_vi", "gather"),
                                          ("feature_vi", "mask"), ("dvi", "gather")])
def test_resume_is_bit_for_bit(ds, L, tmp_path, rules, reduce):
    """A path interrupted in step 4 and resumed from its checkpoints equals
    the uninterrupted one bit for bit (``dvi``: its older anchor is in the
    checkpoint); the reference's ``PathDriver`` agrees within rel 1e-5."""
    full = _driver(rules, L, reduce).run(ds.X, ds.y, **PATH)
    res = _interrupted_then_resumed(ds, L, rules, reduce, tmp_path / "ck")
    np.testing.assert_array_equal(res.weights, full.weights)
    np.testing.assert_array_equal(res.biases, full.biases)
    np.testing.assert_array_equal(res.objectives, full.objectives)
    np.testing.assert_array_equal(res.kept, full.kept)
    np.testing.assert_array_equal(res.extras["keep_masks"], full.extras["keep_masks"])
    deltas = [s.delta for s in res.extras["path_trace"].steps]
    np.testing.assert_array_equal(deltas, [s.delta for s in full.extras["path_trace"].steps])
    assert res.kept[1:].min() < ds.X.shape[0]  # features were screened
    ref = RefDriver(rules, reduce=reduce, L=L, **FIXED).run(
        jnp.asarray(ds.X), jnp.asarray(ds.y), lambdas=full.lambdas)
    rel = np.abs(res.objectives - np.asarray(ref.objectives)) / np.abs(ref.objectives)
    assert rel.max() <= 1e-5


def test_resume_composite_restarts_the_secant(ds, L, tmp_path):
    """``composite`` resumed: the sample rule's secant history starts empty
    (as in the reference), so the steps after the resume may screen fewer
    samples; objectives within rel 1e-5 of the uninterrupted path and every
    screened sample at slack 0 in float64."""
    kw = dict(n_lambdas=6, lam_min_ratio=0.02)
    full = _driver("composite", L, "mask").run(ds.X, ds.y, **kw)
    drv = _driver("composite", L, "mask", ckpt_dir=tmp_path / "ck")
    drv._fault_injector = _stop_at(STOP)
    with pytest.raises(_Stop):
        drv.run(ds.X, ds.y, **kw)
    res = _driver("composite", L, "mask", ckpt_dir=tmp_path / "ck").run(ds.X, ds.y, **kw)
    np.testing.assert_array_equal(res.objectives[:STOP], full.objectives[:STOP])
    assert (np.abs(res.objectives - full.objectives) / np.abs(full.objectives)).max() <= 1e-5
    assert full.kept_samples.min() < ds.X.shape[1]
    margins = ds.y[None, :] * (res.weights @ ds.X.astype(np.float64)
                               + res.biases[:, None])
    for k, mask in res.extras["sample_masks"].items():
        assert not np.any(~mask & (margins[k] < 1.0 - 1e-9)), k


def test_reference_restores_a_port_path_checkpoint(ds, L, tmp_path):
    """The reference's ``restore`` with its launcher's state template reads
    a port path's checkpoint (the extra keys are ignored)."""
    _driver("feature_vi", L, ckpt_dir=tmp_path).run(ds.X, ds.y, **PATH)
    mgr = RefManager(tmp_path)
    assert mgr.latest() == PATH["n_lambdas"] - 1
    m, n = ds.X.shape
    template = {"w": jnp.zeros((m,), jnp.float32), "b": jnp.asarray(0.0, jnp.float32),
                "theta": jnp.zeros((n,), jnp.float32), "delta": jnp.asarray(0.0, jnp.float32),
                "dw": jnp.asarray(0.0, jnp.float32), "db": jnp.asarray(0.0, jnp.float32),
                "k": jnp.asarray(0, jnp.int32)}
    state, manifest = mgr.restore(mgr.latest(), template)
    assert manifest["extra"]["next_k"] == PATH["n_lambdas"]
    assert len(manifest["extra"]["lambdas"]) == PATH["n_lambdas"]
    assert int(state["k"]) == PATH["n_lambdas"] - 1
    res = _driver("feature_vi", L).run(ds.X, ds.y, **PATH)
    np.testing.assert_array_equal(np.asarray(state["w"]), res.weights[-1].astype(np.float32))


def test_resume_refuses_another_grid(ds, L, tmp_path):
    _driver("feature_vi", L, ckpt_dir=tmp_path).run(ds.X, ds.y, **PATH)
    with pytest.raises(ValueError, match="another lambda grid"):
        _driver("feature_vi", L, ckpt_dir=tmp_path).run(ds.X, ds.y, n_lambdas=5)


@pytest.mark.parametrize("change", ["rules", "reduce", "max_iters", "y"])
def test_resume_refuses_another_run(ds, L, tmp_path, change):
    """A checkpoint resumes only the run that wrote it: another rule set,
    reduction, stop rule or problem on the same lambda grid raises."""
    first = _driver("composite", L, ckpt_dir=tmp_path).run(ds.X, ds.y, **PATH)
    lambdas = first.lambdas
    rules, kw, y = "composite", dict(FIXED, ckpt_dir=tmp_path), ds.y
    if change == "rules":
        rules = "feature_vi"  # its records are a subset of composite's
    elif change == "reduce":
        kw["reduce"] = "mask"
    elif change == "max_iters":
        kw["max_iters"] += 1
    else:
        y = ds.y.copy()
        y[:2] = -y[:2]
    with pytest.raises(ValueError, match="another run"):
        PathDriver(rules, L=L, device="cpu", **kw).run(ds.X, y, lambdas=lambdas)


def test_grid_checkpoint_resumes_on_one_device(ds, L, tmp_path):
    """A 2 x 2 grid (rank 0 writes the gathered state) stopped in step 4,
    resumed on one device: the first steps are the grid's, the rest are
    solved here; objectives within rel 1e-5 of the uninterrupted
    single-device path, and safe."""
    cfg = dict(rules="feature_vi", L=L, dir=str(tmp_path / "ck"), stop=STOP,
               max_iters=FIXED["max_iters"], **PATH)
    stops = D.run_grid(interrupted_path, 2, 2, {"X": ds.X, "y": ds.y}, (cfg,),
                       device="cpu", timeout=240.0)
    assert stops == [STOP] * 4
    res = PathDriver("feature_vi", reduce="mask", L=L, ckpt_dir=cfg["dir"],
                     device="cpu", **FIXED).run(ds.X, ds.y, **PATH)
    assert res.extras["checkpoint"]["resumed_at"] == STOP
    full = PathDriver("feature_vi", reduce="mask", L=L, device="cpu", **FIXED).run(
        ds.X, ds.y, **PATH)
    assert (np.abs(res.objectives - full.objectives) / np.abs(full.objectives)).max() <= 1e-5
    np.testing.assert_array_equal(res.extras["keep_masks"][1], full.extras["keep_masks"][1])
    support = np.abs(PathDriver([], L=L, device="cpu", tol=1e-12, max_iters=20000).run(
        ds.X, ds.y, **PATH).weights) > 1e-6
    assert not np.any(support[1:] & ~res.extras["keep_masks"][1:])


def test_launcher_resumes(tmp_path, monkeypatch, capsys):
    """``--ckpt-dir``: a second run of the launcher resumes after the last
    saved step; ``artifacts/svm_path.json`` holds the reference's row keys."""
    monkeypatch.chdir(tmp_path)
    argv = ["--m", "120", "--n", "60", "--n-lambdas", "5", "--device", "cpu",
            "--ckpt-dir", "ck"]
    assert train_main(argv) == 0
    first = capsys.readouterr().out
    assert "resumed" not in first
    assert CheckpointManager(tmp_path / "ck").all_steps() == [3, 4]
    assert train_main(argv) == 0
    assert "resumed at step 5" in capsys.readouterr().out
    rows = json.loads((tmp_path / "artifacts" / "svm_path.json").read_text())
    assert len(rows) == 5
    assert set(rows[1]) == {"lam", "kept", "kept_samples", "nnz", "obj", "iters",
                            "verify_rounds", "wall_s"}
    with pytest.raises(SystemExit):  # the scan engines have no per-step state
        train_main(["--engine", "scan", "--ckpt-dir", "elsewhere", "--device", "cpu"])


def test_launcher_refuses_another_rules_checkpoint(tmp_path, monkeypatch, capsys):
    """Two launcher runs in one directory (the default ``--ckpt-dir``) that
    differ only in ``--rules``: the second refuses the first's checkpoint
    instead of printing its path as its own."""
    monkeypatch.chdir(tmp_path)
    argv = ["--m", "120", "--n", "60", "--n-lambdas", "5", "--lam-min-ratio", "0.02",
            "--device", "cpu"]
    assert train_main([*argv, "--rules", "composite"]) == 0
    capsys.readouterr()
    with pytest.raises(ValueError, match="another run"):
        train_main([*argv, "--rules", "auto"])
    assert "step" not in capsys.readouterr().out


# -- the path server's snapshots ----------------------------------------------------


def _mixed_bucket_jobs():
    """Jobs spanning two bucket groups, so the serve loop drains one group,
    reallocates its slots and drains the other."""
    from repro_torch.launch.path_server import demo_jobs

    small = demo_jobs(2, m=64, n=32, seed=0)
    big = demo_jobs(2, m=96, n=48, seed=10)
    for i, j in enumerate(big):
        j.jid = 2 + i
    return small + big


def _serve(jobs, **kw):
    from repro_torch.launch.path_server import PathServer

    return PathServer(slots=2, device="cpu").serve(jobs, log=lambda *a: None, **kw)


@pytest.mark.parametrize("when", ["late", "early"])
def test_server_snapshot_resume_mixed_buckets(tmp_path, when):
    """A server killed mid-drain on a two-bucket workload and served again
    from its snapshots: killed after the first (small) group drained and
    the slots were reallocated (the snapshot carries the finished jobs of
    the group whose slots are gone), or early, while the first group is
    live. The resumed results are the uninterrupted run's bit for bit."""
    from repro_torch.testing import ServerKilled, kill_server_after

    ref = _serve(_mixed_bucket_jobs())
    assert all(r is not None for r in ref)
    sd = str(tmp_path / "snap")
    total_small = sum(j.n_lambdas for j in _mixed_bucket_jobs()[:2])
    from repro_torch.launch.path_server import PathServer

    crashed = PathServer(slots=2, device="cpu")
    crashed._step_hook = kill_server_after(total_small + 1 if when == "late" else 2)
    with pytest.raises(ServerKilled):
        crashed.serve(_mixed_bucket_jobs(), log=lambda *a: None, snapshot_dir=sd,
                      snapshot_every=1)
    if when == "late":
        assert crashed._group[:2] == (128, 64)  # the second group was live
    resumed = _serve(_mixed_bucket_jobs(), snapshot_dir=sd, snapshot_every=1)
    assert all(r is not None for r in resumed)
    for ra, rb in zip(ref, resumed):
        for name in ("lambdas", "objectives", "weights", "kept"):
            np.testing.assert_array_equal(getattr(ra, name), getattr(rb, name))


def test_reference_reads_a_server_snapshot(tmp_path):
    """The reference's ``restore_raw`` reads the port server's snapshot: the
    slot buffers and every job's stream bit for bit, the manifest's group,
    slots and queue."""
    from repro_torch.launch.path_server import PathServer
    from repro_torch.testing import ServerKilled, kill_server_after

    sd = tmp_path / "snap"
    srv = PathServer(slots=2, device="cpu")
    srv._step_hook = kill_server_after(3)
    with pytest.raises(ServerKilled):
        srv.serve(_mixed_bucket_jobs(), log=lambda *a: None, snapshot_dir=str(sd),
                  snapshot_every=1)
    mine, man = CheckpointManager(sd).restore_raw(3)
    theirs, ref_man = RefManager(sd).restore_raw(3)
    assert set(mine) == set(theirs) and man["extra"] == ref_man["extra"]
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    np.testing.assert_array_equal(mine["X"], srv._X.numpy())
    assert man["extra"]["group"][:2] == [64, 32] and len(man["extra"]["slots"]) == 2
