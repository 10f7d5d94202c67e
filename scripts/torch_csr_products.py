"""Repeatability and cost of the ways to sweep a CSR chunk on the card.

    python scripts/torch_csr_products.py

Generates the news20.binary-shaped instance of ``chip_smoke.py``
(``make_news20_like``, seed 0: 1,355,191 features x 19,996 samples, 9.1M
nonzeros), cuts it into CSR chunks of 2,048 feature rows (662 chunks),
puts every chunk on the card through ``FeatureChunked.stream``, and runs
each product twice over all chunks with the same inputs:

* ``X_c v``: cuSPARSE's CSR SpMV (``torch.mv`` on ``torch.sparse_csr_tensor``),
  ``torch.sparse.mm``, a scatter-add of ``val * v[col]`` by row
  (``index_put_`` with ``accumulate=True``), and the chunk written densely
  into a reused buffer followed by ``torch.mv`` (what the port does);
* ``X_c^T w``: the same scatter-add by column, ``torch.mv`` on the CSC
  transpose, and the dense rows with ``torch.mv`` on their transpose.

Prints one JSON line per product: the chunks whose two results differ in
any bit, the device ms per chunk (CUDA events over the 662 chunks, after
the two runs) and the largest difference from the dense-rows product; and
the card's name and power limit. Needs a CUDA GPU.
"""

import json
import subprocess
import sys
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the instance generator)
from repro_torch.sparse import FeatureChunked  # noqa: E402
from repro_torch.sparse.chunked import dense_rows  # noqa: E402


def csr_tensor(f):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(f.crow, f.col, f.val, size=(f.rows, f.n),
                                       check_invariants=False)


def row_ids(f):
    counts = (f.crow[1:] - f.crow[:-1]).long()
    return torch.repeat_interleave(torch.arange(f.rows, device="cuda"), counts,
                                   output_size=f.val.shape[0])


def scatter_mv(f, v):
    out = torch.zeros(f.rows, device="cuda")
    return out.index_put_((row_ids(f),), f.val * v[f.col.long()], accumulate=True)


def scatter_rmv(f, w):
    out = torch.zeros(f.n, device="cuda")
    return out.index_put_((f.col.long(),), f.val * w[row_ids(f)], accumulate=True)


PRODUCTS = {
    "cusparse_mv": (lambda f, v: torch.mv(csr_tensor(f), v), "v"),
    "sparse_mm": (lambda f, v: torch.sparse.mm(csr_tensor(f), v[:, None])[:, 0], "v"),
    "scatter_mv": (scatter_mv, "v"),
    "dense_rows_mv": (lambda f, v: torch.mv(dense_rows(f), v), "v"),
    "csc_rmv": (lambda f, w: torch.mv(csr_tensor(f).t(), w), "w"),
    "scatter_rmv": (scatter_rmv, "w"),
    "dense_rows_rmv": (lambda f, w: torch.mv(dense_rows(f).t(), w), "w"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    m, n = chip_smoke.NEWS20["m"], chip_smoke.NEWS20["n"]
    (data, cols, indptr), _ = chip_smoke.make_news20_like(**chip_smoke.NEWS20, seed=0)
    fc = FeatureChunked.from_csr((data, cols, indptr, (m, n)), chunk_m=2048)
    forms = [f for _, f in fc.stream("cuda")]
    gen = torch.Generator(device="cuda").manual_seed(3)
    v = torch.randn(n, device="cuda", generator=gen)
    ws = [torch.randn(f.rows, device="cuda", generator=gen) for f in forms]
    for name, (fn, kind) in PRODUCTS.items():
        args = [v] * len(forms) if kind == "v" else ws
        ref = PRODUCTS["dense_rows_mv" if kind == "v" else "dense_rows_rmv"][0]
        a = [fn(f, x) for f, x in zip(forms, args)]
        b = [fn(f, x) for f, x in zip(forms, args)]
        want = [ref(f, x) for f, x in zip(forms, args)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for f, x in zip(forms, args):
            fn(f, x)
        end.record()
        end.synchronize()
        print(json.dumps({
            "product": name, "chunks": len(forms),
            "chunks_differing_on_repeat": sum(not torch.equal(p, q) for p, q in zip(a, b)),
            "device_ms_per_chunk": start.elapsed_time(end) / len(forms),
            "max_abs_diff_vs_dense_rows": max(float((p - q).abs().max())
                                              for p, q in zip(a, want))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
