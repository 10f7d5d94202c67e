"""The LM's mesh forms on real values: a 2 x 2 ("data", "model") mesh over
four spawned gloo ranks on the CPU (``core.distributed.run_grid``; the rank
program is ``tests/_torch_mesh_ranks.py``, which imports no JAX).

For the dense family (qwen2.5-3b), the MoE ones (deepseek-v2-236b,
arctic-480b: the one-hot dispatch and combine, the experts on the model
axis), the SSM (mamba2-130m: the SSD chunks on each rank's heads) and the
hybrid (recurrentgemma-9b: the RG-LRU scan on each rank's channels),
float32 SMOKE widths, a 4 x 64 batch sharded on "data":

* the prefill's logits through the placed parameters against the plain
  prefill's, within rel :data:`REL`;
* one train step's gradients (``launch.steps._value_and_grads``), each
  leaf gathered whole, against the plain step's, within rel :data:`REL` of
  the leaf's largest plain gradient. This holds the gradients that a rank
  computes from its own shards only: an input replicated on an axis where
  the product's output is sharded (the MoE's tokens and expert weights,
  the SSD's ``A``, ``B`` and ``C``) has a gradient that is a sum over that
  axis.

Every rank returns the same gathered values; all are checked.
"""

import numpy as np
import pytest

from repro_torch.core.distributed import run_grid

from _torch_mesh_ranks import mesh_against_plain

ARCHS = ("qwen2.5-3b", "deepseek-v2-236b", "arctic-480b", "mamba2-130m",
         "recurrentgemma-9b")
REL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, one spawn of the 2 x 2 mesh for all archs."""
    return run_grid(mesh_against_plain, model=2, data=2, args=(ARCHS, 2, 2), device="cpu",
                    timeout=900.0)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(np.abs(a).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_on_a_2x2_mesh_match_the_plain_prefill(ranks, arch):
    for r in ranks:
        got, want = r[arch]["logits"]
        assert np.isfinite(got).all()
        assert _rel(got, want) <= REL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_gradients_on_a_2x2_mesh_match_the_plain_step(ranks, arch):
    placed = ranks[0][arch]["placements"]
    assert any("Shard" in p for p in placed.values()), placed
    for r in ranks:
        errs = {p: _rel(a, b) for p, (a, b) in r[arch]["grads"].items()}
        bad = {p: (e, placed[p]) for p, e in errs.items() if not e <= REL}
        assert not bad, bad
