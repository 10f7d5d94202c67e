"""The LM serving loop (``repro_torch.launch.serve``, ``.steps``) on the CPU.

* ``BatchedServer`` against the reference's on the same requests and the
  reference's weights (float32 ``SMOKE`` qwen2.5-3b, 6 requests on 3
  slots): every request's greedy tokens equal (the logits agree to ~4e-7,
  far inside the gaps between their largest values).
* The port on its own: a request's first decode logits in a full batch
  against the same request served alone on a server of the same shape
  (rel 1e-5, float32: the other slots' rows do not reach its row).
* The same for the other families' ``SMOKE`` configs (deepseek-v2-236b:
  MLA and MoE with a shared expert; arctic-480b: MoE with a dense residual;
  mamba2-130m; recurrentgemma-9b, its 16-slot window under prompts of up to
  23 tokens; internvl2-26b on tokens alone, as the reference's server), 6
  requests on 3 slots: the greedy tokens equal. An enc-dec model raises
  ``ValueError`` at the server's construction.
* ``main`` runs with ``--device cpu`` and raises for ``--device cuda``
  without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tr
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import transformer as tr
from repro_torch.testing.lm import StepRecorder


def _quiet(*a, **k):
    return None


def _prompts(vocab, n, seed=0):
    """The reference launcher's requests: 4 to 23 tokens, 8 new ones."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(4, 24)).astype(np.int32) for _ in range(n)]


def test_batched_server_matches_reference():
    ref_cfg = ref_smoke("qwen2.5-3b").replace(dtype="float32")
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype="float32")
    ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    prompts = _prompts(cfg.vocab_size, 6)

    ref_reqs = [ref_serve.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    ref_serve.BatchedServer(ref_cfg, ref_params, batch_slots=3, max_seq=128).serve(
        ref_reqs, log=_quiet)
    reqs = [serve.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    server = serve.BatchedServer(cfg, params, batch_slots=3, max_seq=128, device="cpu")
    server.serve(reqs, log=_quiet)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(r.done and len(r.out) == 8 for r in reqs)
    # a float32 model's cache comes back float32 from decode, as the reference's
    assert server.cache["segments"][0]["s0"]["k"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b", "mamba2-130m",
                                  "recurrentgemma-9b", "internvl2-26b"])
def test_batched_server_matches_reference_other_families(arch):
    ref_cfg = ref_smoke(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    prompts = _prompts(cfg.vocab_size, 6)

    ref_reqs = [ref_serve.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    ref_serve.BatchedServer(ref_cfg, ref_params, batch_slots=3, max_seq=128).serve(
        ref_reqs, log=_quiet)
    reqs = [serve.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    serve.BatchedServer(cfg, params, batch_slots=3, max_seq=128, device="cpu").serve(
        reqs, log=_quiet)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(r.done and len(r.out) == 8 for r in reqs)


def test_encdec_server_raises():
    cfg = get_smoke_config("whisper-base")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="enc-dec"):
        serve.BatchedServer(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="enc-dec"):
        serve.main(["--arch", "whisper-base", "--device", "cpu"])


def test_first_decode_matches_request_served_alone():
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype="float32")
    params = tr.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = _prompts(cfg.vocab_size, 5, seed=1)
    batched = serve.BatchedServer(cfg, params, batch_slots=3, max_seq=64, device="cpu")
    rec = StepRecorder(batched)
    batched.serve([serve.Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)],
                  log=_quiet)
    for rid in (0, 4):  # one in the first fill, one that waited for a slot
        alone = serve.BatchedServer(cfg, params, batch_slots=3, max_seq=64, device="cpu")
        rec_alone = StepRecorder(alone)
        alone.serve([serve.Request(rid=rid, prompt=prompts[rid], max_new=6)], log=_quiet)
        a, b = dict(rec.decodes(rid))[1], dict(rec_alone.decodes(rid))[1]
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


def test_main_runs_on_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    assert serve.main(["--device", "cpu", "--requests", "4", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 4 requests, 32 tokens" in out
    assert sum(line.startswith("  req ") for line in out.splitlines()) == 4


def test_cuda_request_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main([])  # the default device is the GPU
    cfg = get_smoke_config("qwen2.5-3b")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.BatchedServer(cfg, params)
