"""The port's data generator is a copy of the reference's: same seed, same bits."""

import numpy as np
import pytest

from repro.data import make_sparse_classification as ref_make
from repro_torch.data import make_sparse_classification as port_make


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("density", [1.0, 0.3, 0.05])
def test_make_sparse_classification_bit_identical(seed, density):
    kw = dict(m=120, n=50, k_active=7, density=density, seed=seed)
    ref, port = ref_make(**kw), port_make(**kw)
    for name in ("X", "y", "w_true"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), name
    if density < 1.0:
        for name in ("data", "indices", "indptr"):
            assert np.array_equal(getattr(ref.csr, name), getattr(port.csr, name))
        assert ref.csr.shape == port.csr.shape
        assert np.array_equal(port.csr.to_dense(), port.X)
    else:
        assert ref.csr is None and port.csr is None


def test_correlated_design_bit_identical():
    kw = dict(m=80, n=40, correlated=0.5, seed=5)
    assert np.array_equal(ref_make(**kw).X, port_make(**kw).X)
