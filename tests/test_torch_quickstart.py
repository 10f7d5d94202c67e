"""The port's quickstart (``repro_torch.examples.quickstart``), the
counterpart of the reference's ``examples/quickstart.py``.

* ``main(["--device", "cpu"])`` prints all eleven sections (the
  reference's lines) and its comparisons hold, at the tolerances the
  port's own tests hold those paths to: the reduced and the full solve's
  objectives rel 1e-5 (one fp32 optimum reached from two matrices); the
  out-of-core path against the in-core one rel 1e-5 (as
  ``test_torch_sparse_stream.py``); server job 0 against its sequential
  scan path rel 1e-6 (as ``test_torch_path_server.py``); the scan engine
  against the host path rel 1e-5. It runs on one thread: ~10 s.
* Its opening sections against the JAX package on the same seeded
  2,000 x 300 data, through the reference's own functions (its script
  takes minutes): ``lambda_max`` rel 1e-5; the keep mask of the screen at
  0.7 lambda_max equal outside a 1e-4 band around the threshold (bounds
  of fp32 sums in another order); section 5's path objectives rel 1e-5.
* Without a GPU the default device raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lambda_max as ref_lambda_max
from repro.core import screen as ref_screen
from repro.core import svm_path as ref_svm_path
from repro.core import theta_at_lambda_max as ref_theta
from repro.data import make_sparse_classification as ref_data
from repro_torch.core import lambda_max, screen, svm_path
from repro_torch.core.dual import theta_at_lambda_max
from repro_torch.core.screening import SAFE_TAU
from repro_torch.data import make_sparse_classification
from repro_torch.examples import quickstart

SECTIONS = ("lambda_max = ", "screening keeps ", "objective reduced=", "path kept counts :",
            "registered rules: ", "feature_vi kept features", "sample_vi  kept features",
            "composite  kept features", "dvi        kept features",
            "dynamic in-solver tightening", "scan engine: ", "compact scan: ",
            "  caps :", "out-of-core path (storage=csr, 8 chunks)",
            "  max feature rows ever on device:", "path server (4 ragged jobs, 2 slots):",
            "  grid lengths : [4, 7, 5, 9]", "  job 0 vs sequential svm_path obj diff:")


@pytest.fixture(autouse=True)
def one_thread():
    """One thread: the workers of a parallel run share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def test_quickstart_runs_every_section_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    pos = [text.find(s) for s in SECTIONS]
    assert all(p >= 0 for p in pos), [s for s, p in zip(SECTIONS, pos) if p < 0]
    assert pos == sorted(pos)
    assert f"/{2000} features" in text and "4000 of m=4000" not in text

    assert _rel(out["obj_reduced"], out["obj_full"]) <= 1e-5
    keep = out["keep"]
    assert 0 < keep.sum() < keep.size
    path = out["path"]
    assert path.kept[0] == 0 and path.objectives.shape == (8,)
    for spec, r in out["rules"].items():
        assert _rel(r.objectives, out["rules"]["feature_vi"].objectives) <= 1e-5, spec
    assert out["rules"]["composite"].kept_samples[-1] < 300
    assert _rel(out["scan"].objectives, path.objectives) <= 1e-5
    assert _rel(out["compact"].objectives, path.objectives) <= 1e-5
    assert _rel(out["out_of_core"].objectives, out["in_core"].objectives) <= 1e-5
    assert out["out_of_core"].extras["stream_stats"]["max_put_rows"] == 512
    assert _rel(out["server_job0"].objectives, out["server_seq0"].objectives) <= 1e-6
    assert out["server"].last_serve["retraces"] == 0


def test_quickstart_opening_sections_match_the_reference():
    ds = make_sparse_classification(m=2000, n=300, k_active=12, seed=0)
    rds = ref_data(m=2000, n=300, k_active=12, seed=0)
    assert np.array_equal(ds.X, rds.X) and np.array_equal(ds.y, rds.y)
    X, y = torch.from_numpy(ds.X), torch.from_numpy(ds.y)
    rX, ry = jnp.asarray(rds.X), jnp.asarray(rds.y)

    lmax, rlmax = float(lambda_max(X, y)), float(ref_lambda_max(rX, ry))
    assert lmax == pytest.approx(rlmax, rel=1e-5)

    keep, bounds = screen(X, y, lmax, 0.7 * lmax,
                          theta_at_lambda_max(y, torch.tensor(lmax)))
    rkeep, rbounds = ref_screen(rX, ry, rlmax, 0.7 * rlmax, ref_theta(ry, jnp.asarray(rlmax)))
    rbounds = np.asarray(rbounds)
    clear = np.abs(rbounds - SAFE_TAU) > 1e-4
    assert clear.sum() > 1900
    assert np.array_equal(keep.numpy()[clear], np.asarray(rkeep)[clear])
    np.testing.assert_allclose(bounds.numpy(), rbounds, rtol=1e-4, atol=1e-4)

    path = svm_path(ds.X, ds.y, n_lambdas=8, lam_min_ratio=0.1, device="cpu")
    ref = ref_svm_path(rds.X, rds.y, n_lambdas=8, lam_min_ratio=0.1)
    np.testing.assert_allclose(path.lambdas, np.asarray(ref.lambdas), rtol=1e-6)
    assert _rel(path.objectives, np.asarray(ref.objectives)) <= 1e-5


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is there")
def test_quickstart_defaults_to_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])
