"""``python _faulty_run.py FAULT [run.py arguments]``: one run of the
harness with the port's solve broken underneath, for the harness's tests.

FAULT is ``unchanged`` (every solve returns its warm start: zero
iterations), ``half_batch`` (every solve drops the second half of its
samples from the loss), ``altered`` (every solve's answer loses its
largest weight) or ``no_floor`` (the scan engine's certificate takes its
fp32 gap with no floor, as the host engine's does). The first three
patch both engines' solves: the host engine's ``PathDriver._solve`` and
the scan engine's ``path_scan._solve``.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _half(mask, n, like):
    half = torch.ones((n,), dtype=like.dtype, device=like.device)
    half[n // 2:] = 0.0
    return half if mask is None else mask * half


def _altered(res):
    w = res.w.clone()
    w[torch.argmax(torch.abs(w))] = 0.0
    return res._replace(w=w)


def apply(fault: str) -> None:
    from repro_torch.core import path, path_scan, solver

    if fault == "no_floor":
        certify = path_scan.gap_theta_delta

        def unfloored(*args, **kw):
            saved, solver._EPS32 = solver._EPS32, 0.0  # the floor's 4 eps |P|
            try:
                return certify(*args, **kw)
            finally:
                solver._EPS32 = saved

        path_scan.gap_theta_delta = unfloored
        return

    host, scan = path.PathDriver._solve, path_scan._solve

    def host_solve(self, X, y, lam, w0, b0, L, valid_m=None, sample_mask=None, **kw):
        if fault == "unchanged":
            saved, self.max_iters = self.max_iters, 0
            try:
                return host(self, X, y, lam, w0, b0, L, valid_m, sample_mask, **kw)
            finally:
                self.max_iters = saved
        if fault == "half_batch":
            sample_mask = _half(sample_mask, X.shape[1], X)
        res = host(self, X, y, lam, w0, b0, L, valid_m, sample_mask, **kw)
        return _altered(res) if fault == "altered" else res

    def scan_solve(Xs, ye, sme, lam, w0, b0, fms, inv_L, vm, o):
        if fault == "unchanged":
            o = dict(o, max_iters=0)
        if fault == "half_batch":
            sme = _half(sme, Xs.shape[1], Xs)
        res = scan(Xs, ye, sme, lam, w0, b0, fms, inv_L, vm, o)
        return _altered(res) if fault == "altered" else res

    path.PathDriver._solve = host_solve
    path_scan._solve = scan_solve


if __name__ == "__main__":
    from svmbench import run

    apply(sys.argv[1])
    raise SystemExit(run.main(sys.argv[2:]))
