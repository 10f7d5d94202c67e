"""The port's train step and trainer (``repro_torch.launch.steps``,
``launch.train``), the token pipeline and the two examples, on the CPU.

* ``make_train_step`` against the reference's over 3 steps, from one state
  carried across (``convert.train_state_from_jax``), with 1 and 2
  microbatches: metrics within rel 1e-5, parameters and moments within
  1e-5 of each leaf's scale (measured up to ~1e-6).
* ``TokenPipeline.batch_at`` bit for bit the reference's.
* NaN rejection, resume and SIGTERM: exact (bit for bit).
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_train_ref import one_thread  # noqa: F401 (autouse)
from repro.configs import get_smoke_config as ref_smoke
from repro.data import TokenPipeline as RefPipeline
from repro.launch import steps as ref_steps
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import train_state_from_jax, tree_keys
from repro_torch.data import TokenPipeline, synthetic_batch_specs
from repro_torch.launch import steps, train as train_mod
from repro_torch.launch.train import train
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves


def _quiet(*a, **k):
    pass


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch,micro", [("granite-8b", 1), ("granite-8b", 2),
                                        ("deepseek-v2-236b", 2)])
def test_train_step_matches_reference(arch, micro):
    """3 steps of each package's ``make_train_step`` (warmup 2 of 3 steps,
    so the rate moves), the reference's state carried across first."""
    ref_cfg = ref_smoke(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    rs = ref_steps.init_train_state(ref_cfg, jax.random.PRNGKey(0))
    st = train_state_from_jax(rs, cfg, "cpu")
    kw = dict(warmup_steps=2, total_steps=3, microbatches=micro)
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, **kw))
    step = steps.make_train_step(cfg, **kw)
    pipe = TokenPipeline(cfg.vocab_size, 4, 32, seed=0)
    for s in range(3):
        b = pipe.batch_at(s)
        rs, rm = ref_step(rs, {k: jnp.asarray(v) for k, v in b.items()})
        st, m = step(st, _tensors(b))
        assert set(m) == set(rm), (sorted(m), sorted(rm))
        assert m["skipped"] == int(rm["skipped"]) == 0
        for k in set(m) - {"skipped"}:
            want = float(rm[k])
            assert abs(m[k] - want) <= 1e-5 * abs(want) + (1e-7 if k == "aux" else 0), (s, k)
    assert int(st.opt.step) == int(rs.opt.step) == 3
    for got, ref in ((st.params, rs.params), (st.opt.mu, rs.opt.mu), (st.opt.nu, rs.opt.nu)):
        want = tree_keys(jax.tree_util.tree_map(np.asarray, ref))
        for key, t in tree_keys(got).items():
            assert _rel(t.numpy(), want[key]) <= 1e-5, key


def test_token_pipeline_matches_reference_bit_for_bit():
    for seed, vocab, b, s in ((0, 256, 4, 16), (3, 151_936, 2, 33), (7, 50_280, 3, 8)):
        mine, ref = TokenPipeline(vocab, b, s, seed=seed), RefPipeline(vocab, b, s, seed=seed)
        for step in (0, 1, 12, 1_000):
            got, want = mine.batch_at(step), ref.batch_at(step)
            assert set(got) == set(want) == {"tokens", "targets"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                assert np.array_equal(got[k], want[k])
        first, again = next(iter(mine)), mine.batch_at(0)
        assert all(np.array_equal(first[k], again[k]) for k in first)
    specs = synthetic_batch_specs(4, 16, 256)
    got = TokenPipeline(256, 4, 16).batch_at(0)
    assert {k: (v.shape, v.dtype) for k, v in specs.items()} == \
        {k: (v.shape, v.dtype) for k, v in got.items()}


def test_nan_step_is_rejected_and_leaves_the_state_bit_for_bit():
    """A poisoned parameter (the embedding times NaN) makes the loss NaN:
    the step reports ``skipped = 1`` and leaves every parameter, both
    moments and the step exactly as they were; the next clean step runs."""
    cfg = get_smoke_config("granite-8b")
    st = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = steps.make_train_step(cfg)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
             "targets": torch.zeros((2, 16), dtype=torch.int32)}
    st, m1 = step(st, batch)
    assert m1["skipped"] == 0
    clean = st.params["embed"]["tok"].clone()
    st.params["embed"]["tok"].mul_(float("nan"))
    before = [t.clone() for t in leaves(st)]
    st2, m2 = step(st, batch)
    assert m2["skipped"] == 1 and not np.isfinite(m2["loss"])
    after = leaves(st2)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before) if a.is_floating_point()
               and a is not st2.params["embed"]["tok"])
    assert torch.isnan(st2.params["embed"]["tok"]).all()
    assert int(st2.opt.step) == 1
    st2.params["embed"]["tok"].copy_(clean)
    _, m3 = step(st2, batch)
    assert m3["skipped"] == 0 and np.isfinite(m3["loss"])


def test_uneven_microbatches_raise():
    """B = 3 rows do not split into 2 microbatches: the step raises
    ``ValueError`` naming both (the reference's reshape raises too), where
    it once dropped the last row; an even split still runs."""
    cfg = get_smoke_config("qwen2.5-3b")
    st = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = steps.make_train_step(cfg, microbatches=2)
    odd = {"tokens": torch.zeros((3, 16), dtype=torch.int32),
           "targets": torch.zeros((3, 16), dtype=torch.int32)}
    with pytest.raises(ValueError, match=r"3 rows.*microbatches=2"):
        step(st, odd)
    assert int(st.opt.step) == 0
    even = {k: v[:2] for k, v in odd.items()}
    _, m = step(st, even)
    assert m["skipped"] == 0 and np.isfinite(m["loss"])


def test_bf16_moment_state_checkpoint_round_trips_bit_for_bit(tmp_path):
    """``init_train_state(moment_dtype=torch.bfloat16)`` after one step: the
    checkpoint restores every leaf bit for bit in its dtype, the bf16
    moments among them (numpy has no bfloat16; the manager writes their
    2-byte values)."""
    cfg = get_smoke_config("qwen2.5-3b")
    st = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu",
                                moment_dtype=torch.bfloat16)
    batch = {"tokens": torch.arange(32, dtype=torch.int32).reshape(2, 16) % 7,
             "targets": torch.arange(32, dtype=torch.int32).reshape(2, 16) % 5}
    st, _ = steps.make_train_step(cfg)(st, batch)
    assert leaves(st.opt.mu)[0].dtype == torch.bfloat16
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, st)
    template = steps.init_train_state(cfg, torch.Generator().manual_seed(1), "cpu",
                                      moment_dtype=torch.bfloat16)
    back, _ = mgr.restore(1, template)
    assert isinstance(back, steps.TrainState)
    for a, b in zip(leaves(st), leaves(back), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert any(bool(t.ne(0).any()) for t in leaves(back.opt.mu))


def test_resume_is_exact(tmp_path):
    """Stopped after 8 of 16 steps and resumed: the resumed steps' losses and
    the final parameters and moments are the uninterrupted run's, bit for
    bit (the pipeline replays each step's batch; the checkpoint holds the
    parameters, both moments and the step)."""
    kw = dict(smoke=True, batch=4, seq=32, ckpt_every=8, log=_quiet, device="cpu")
    full = train("granite-8b", steps=16, ckpt_dir=str(tmp_path / "full"), **kw)
    part = train("granite-8b", steps=8, ckpt_dir=str(tmp_path / "res"), **kw)
    resumed = train("granite-8b", steps=16, ckpt_dir=str(tmp_path / "res"), **kw)
    assert len(part["losses"]) == 8 and len(resumed["losses"]) == 8
    assert part["losses"] == full["losses"][:8]
    assert resumed["losses"] == full["losses"][8:]
    a, b = leaves(full["final_state"]), leaves(resumed["final_state"])
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert isinstance(resumed["final_state"], steps.TrainState)


def test_loss_decreases_short_run(tmp_path):
    """15 steps of qwen2.5-3b's SMOKE config (batch 4 x 64, still in the
    100-step warmup): the mean loss over the pipeline's first 3 batches,
    evaluated with the final parameters, is below the initial parameters'
    (one step's loss on its own batch is noisier than the descent)."""
    out = train("qwen2.5-3b", smoke=True, steps=15, batch=4, seq=64, ckpt_dir=str(tmp_path),
                ckpt_every=50, log=_quiet, device="cpu")
    cfg = get_smoke_config("qwen2.5-3b")
    init = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    pipe = TokenPipeline(cfg.vocab_size, 4, 64, seed=0)

    @torch.no_grad()
    def mean_loss(params):
        return np.mean([float(tr.loss_fn(params, cfg, _tensors(pipe.batch_at(s)))[0])
                        for s in range(3)])
    assert mean_loss(out["final_state"].params) < mean_loss(init.params)
    assert out["skipped"] == 0 and all(np.isfinite(out["losses"]))


def test_sigterm_flushes_a_checkpoint_and_restores_the_handler(tmp_path):
    """SIGTERM during step 5: step 6 runs, its checkpoint is written, the
    trainer returns, and the handler installed before it is back."""
    seen = []

    def previous(_sig, _frm):
        seen.append("previous")

    old = signal.signal(signal.SIGTERM, previous)
    try:
        logs = []

        def log(msg):
            logs.append(msg)
            if "step=5 " in msg:
                os.kill(os.getpid(), signal.SIGTERM)

        out = train("qwen2.5-3b", smoke=True, steps=20, batch=2, seq=16,
                    ckpt_dir=str(tmp_path), ckpt_every=100, log=log, device="cpu")
        assert signal.getsignal(signal.SIGTERM) is previous
        assert seen == []  # the trainer's handler took the signal
    finally:
        signal.signal(signal.SIGTERM, old)
    assert out["last_step"] == 6 and len(out["losses"]) == 7
    assert any("preempted at step 6" in m for m in logs)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest() == 6
    _, manifest = mgr.restore_raw(6)
    assert manifest["extra"]["next_step"] == 7


def test_heartbeat_file(tmp_path):
    """Each step rewrites ``heartbeat.json`` with its step, loss and the
    deadline; a step past the deadline logs a warning."""
    logs = []
    out = train("qwen2.5-3b", smoke=True, steps=3, batch=2, seq=16, ckpt_dir=str(tmp_path),
                ckpt_every=100, step_deadline_s=0.0, log=logs.append, device="cpu")
    hb = json.loads((tmp_path / "heartbeat.json").read_text())
    assert hb["step"] == 2 and hb["loss"] == out["losses"][-1] and hb["deadline_s"] == 0.0
    assert sum("exceeded deadline" in m for m in logs) == 3


def test_train_main_on_the_cpu(tmp_path, capsys):
    out = train_mod.main(["--arch", "granite-8b", "--smoke", "--steps", "3", "--batch", "2",
                          "--seq", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(out["losses"]) == 3 and "[train] done." in capsys.readouterr().out
    assert CheckpointManager(tmp_path).latest() == 2


def test_train_lm_example_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The example's whole main (arguments, ``train``, its descent check) at
    a small size: its ~15M-parameter variant replaced by the SMOKE config."""
    from repro_torch.examples import train_lm

    monkeypatch.setattr(train_lm, "small_config", get_smoke_config)
    out = train_lm.main(["--device", "cpu", "--steps", "15", "--batch", "4", "--seq", "64",
                         "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 15
    assert "[example] initial loss" in capsys.readouterr().out


def test_train_lm_example_small_config():
    from repro_torch.examples.train_lm import small_config

    cfg = small_config("mamba2-130m")
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (24, 256, 8192)
    assert 10e6 < cfg.param_count() < 20e6


def test_sparse_probe_example_main_on_the_cpu(capsys):
    """The reference's settings (SMOKE qwen2.5-3b in float32, 30 steps of 8 x
    64 tokens, 192 probe sequences, 6 lambdas down to 0.15): the path's
    objectives finite, the first step keeps nothing (lambda_max), the
    features standardized."""
    from repro_torch.examples import sparse_probe

    out = sparse_probe.main(["--device", "cpu"])
    path = out["path"]
    assert len(path.lambdas) == 6 and np.all(np.isfinite(path.objectives))
    assert path.active[0] == 0 and path.active[-1] > 0
    assert 0.5 < out["accuracy"] <= 1.0
    assert "[probe] fit accuracy" in capsys.readouterr().out
