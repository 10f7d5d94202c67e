"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version, and drives
two paths through the kernels at full width (m = 50,000 features x
n = 10,000 samples, fp32):

* the paper's screened path (``repro_torch.core.path.svm_path``, feature
  rule, 8 lambdas, lam_min_ratio 0.1), checked for finite objectives that
  match a float64 recomputation, agreement with the plain (CPU) path on the
  2000 x 400 bench instance, and screening safety against the unscreened
  path on the first 4 lambdas;
* the verified sample-screening path (``rules="composite"``, 8 lambdas,
  lam_min_ratio 0.02), checked for objectives against float64, the
  zero-slack certificate of every screened sample at the accepted
  solution, and card-vs-CPU agreement on the bench instance in both
  reductions (``"gather"``, ``"mask"``);
* both again with dynamic (in-solver) screening every 50 iterations
  (``dynamic=True``): the feature path in gather mode, checked against
  float64, against the unscreened path for safety and against the
  sequential path's objectives (rel 1e-5); the composite path in mask mode
  with the in-solver sample re-screen, checked for the zero-slack
  certificate; and the bench instance dynamic on the card and the CPU.
  Both dynamic paths are then timed against their sequential twins in turns
  (``path_walls``), and one refresh is timed in its parts;
* the rest of the feature-rule zoo: ``rules="edpp"`` and ``rules="auto"``
  on the feature path's grid, checked for safety against the unscreened
  path, objectives against float64 and their kept counts beside the VI
  path's (``auto`` also prints its probes and sweep seconds), and
  ``rules="sifs"`` (EDPP features, verified samples, gather) on the
  composite grid, checked for the zero-slack certificate, with one float64
  verification round timed; ``edpp`` and ``sifs`` again on the bench
  instance, card against CPU at fixed iterations;
* the on-device path engines (``engine="scan"``: every FISTA decision on
  the card, each chunk of iterations a replayed CUDA graph): the feature
  path with ``reduce="compact"`` (``scan_path``: safety against the
  unscreened path, objectives against float64 and the host engine's, host
  fetches and graph replays, walls in turns with the host engine), the
  bench instance in mask and compact mode with ``edpp`` and ``dvi``, card
  against CPU (``scan_small_vs_plain``), the batched engine on 4 grids of
  the full-width X and on 2 full-width problems (``batched_path``: each
  element against the single-path engine at fixed iterations), and the
  scan engine with dynamic screening (``scan_dynamic``); then the device
  memory that the engines' warm cache holds, and what clearing it frees
  (``engine_memory``);
* out-of-core storage (``repro_torch.sparse.FeatureChunked``): the
  full-width X as 25 host chunks of 2,048 rows streamed through a pinned
  double buffer (``chunked_path``: step 1's bounds bit for bit those of the
  in-core kernel launch, safety against the unscreened path, objectives
  against float64 and within rel 1e-5 of the in-core path, walls in turns
  with it); a text-like instance at the shape of LIBSVM's news20.binary
  (1,355,191 features x 19,996 samples, 9,097,916 nonzeros, 108 GB as a
  dense fp32 matrix, more than the card holds), generated as CSR, saved
  to a memmap store and reopened (``chunked_sparse_path``: chunk skipping,
  the full-stream twin bit for bit, a float64 KKT check of every screened
  feature, peak device memory under its stated limit); and the 2,000 x
  400 bench instance, dense and at density 0.04, card against CPU
  (``chunked_small_vs_plain``);
* the sharded lanes (``core/distributed.py``): a ``1 x 1`` grid bit for
  bit the scan engine; spawned 2 x 2, 4 x 1 and 1 x 4 grids of ranks
  sharing the card over gloo (step 1's screen; on 2 x 2 the scan path and
  the composite host lane, ``PathDriver(grid=..., reduce="mask")``, at
  fixed iterations); the host lane's other options on the bench instance
  (``host_lane_grid``: ``edpp`` and ``dvi`` on 2 x 2 and 1 x 4, ``auto``
  and exact Lipschitz on 2 x 2, each against one device); card ranks
  against CPU ranks; each partial mode timed on a 2 x 2 block;
* the path server (``launch/path_server.py``): six tenants cut from the
  full-width X (50,000 x 10,000 down to 33,000 x 9,000) drained through four
  padded slots of the (65,536, 16,384) bucket, then three EDPP tenants of
  ~20,000 x 4,000 on the same server's reallocated slots, the feature
  screen's weighted EDPP mode under their sample masks (``serve``: every
  job within rel 1e-5 of its own scan path, padded rows exactly 0, safety
  against one tenant's unscreened path, the program cache warm with no
  graph re-captured, jobs/s, latencies, occupancy and peak memory); a
  server killed mid-drain and resumed from its snapshots bit for bit, a
  quarantined tenant, a retried one and a deadline, at the bench size
  (``serve_snapshot``, ``serve_faults``);
* checkpoints, faults and tracing on the full-width feature path
  (``checkpoint_resume``: interrupted in step 4 and resumed, bit for bit
  the uninterrupted path, each save's seconds and bytes; ``faults``: a
  poisoned step refused and recovered, a corrupt store detected before
  any screen and the launcher's exit code 2 on it; ``trace``: tracing off
  and on in turns, every step's spans against its walls, and the
  launcher's ``--profile`` captures with the kernels' names and the card's
  busy share);
* the LM scaffold's serving path (``repro_torch.models``,
  ``launch/serve.py``), after the kernels' times; its products and
  softmaxes are plain PyTorch, no kernel of this repository, so it adds no
  row to the kernels line: the four dense archs' reduced configs in float32,
  card against CPU (prefill logits, every cache leaf, 4 decode steps, a
  ``BatchedServer``'s greedy tokens) and qwen2.5-3b at full width on 2
  layers (``lm_card_vs_cpu``); the same for the six other families'
  reduced configs (MLA and MoE, Mamba-2, the RG-LRU hybrid, enc-dec without
  the server, the VLM with prefix embeddings) and whisper-base whole, 1,500
  encoder frames (``lm_families_card_vs_cpu``); then four configurations at
  their published widths, bf16 over float32 masters from a seeded generator
  on the card, each serving 8 requests on 4 slots, 32 new tokens each
  (every logit finite, two requests' decode steps against teacher-forced
  prefills and their first decode against the request served alone;
  prefill and decode-step times beside their bounds, tokens/s, peak memory,
  the card's busy share over three decode steps): qwen2.5-3b whole, prompts
  of 64 to 1,024 tokens on 2,048 positions (``lm_serve``); deepseek-v2-236b
  on 2 of its 60 layers, its routed experts read and (token, choice) pairs
  dropped (``lm_serve_moe``); mamba2-130m whole, prompts of 64 to 1,024
  tokens below its chunk or multiples of it (``lm_serve_ssm``);
  recurrentgemma-9b on 5 of its 38 layers, one prompt of 2,560 tokens past
  its 2,048 window, on 4,096 positions (``lm_serve_hybrid``);
* the LM training path (``launch/steps.py``, ``launch/train.py``, the
  models' ``train`` mode, ``optim/``), plain PyTorch and autograd, no kernel
  of this repository: the ten SMOKE configs in float32, one train step card
  against CPU (loss, ``ce``, ``aux``, grad norm, every parameter and moment
  after the update), 3 more steps' losses, and ``remat`` none, full and dots
  on the card (``lm_train_card_vs_cpu``); qwen2.5-3b's published
  configuration trained for 8 steps of 4 x 1,024 tokens, bf16 over float32
  masters and moments, ``remat="full"`` (``lm_train``: step ms beside its
  bound, tokens/s, the card's busy share and kernels over a profiled step,
  peak memory); the LM mesh on that trained state (``lm_mesh``: the dry
  run's (1, 1) per-rank state bytes equal to the state's own bytes, its
  (16, 16) and (2, 16, 16) per-rank bytes, the parameters placed by the
  sharding rules on a (1, 1) CUDA ``DeviceMesh`` over NCCL, each local
  shard the whole leaf bit for bit, and a 1 x 64 prefill through the placed
  parameters bit for bit the plain prefill's); then the sparse probe, the paper's path on that model's
  features (``sparse_probe``: 2,048 features x 4,096 samples, final-norm
  last-position features of 4,096 sequences of 64 tokens; safe against the
  unscreened path, objectives against float64, card against CPU, the
  feature-screen, margin and gradient kernels launched and held against
  their plain versions at that shape; then the reference-sized example on
  the card); and the trainer on mamba2-130m whole, 40 steps against 20 and
  a resume to 40, under deterministic algorithms, bit for bit
  (``lm_train_resume``). The probe's launches join the kernels line;
* the MoE families on a mesh (``lm_mesh_moe``): a 1 x 64 prefill through
  placed parameters on a (1, 1) CUDA ``DeviceMesh`` over NCCL, where the
  MoE layers take the reference's one-hot dispatch and combine over all
  experts, against the same prefill on plain tensors (the scatter over
  the experts that hold a token): deepseek-v2-236b's and arctic-480b's
  reduced configs in float32 (logits and every cache leaf within rel
  1e-5, the routing equal) and deepseek-v2-236b's widths on 2 of 60
  layers, bf16 over float32 masters (the routing equal but for named near
  ties, the logits within rel 3e-2, or ``LM_FLIP_REL`` where a route
  moved); seconds and peak memory;
* the port's quickstart (``repro_torch.examples.quickstart``, the
  reference's ``examples/quickstart.py`` sections 1-11) on the card, with
  the launch counts set to 0 just before it and read just after: the
  margin, gradient, feature-screen and sample-sweep kernels each launched,
  and its comparisons held (the reduced against the full objective, the
  out-of-core path against the in-core one, server job 0 against its
  sequential scan path: rel 1e-5); its wall. Its launches join the
  kernels line (``launches_quickstart``).

Each path runs with the launch counts set to 0 just before it and read just
after, and fails if one of its kernels was never launched, or if the
margin, gradient, sample-surplus or feature-screen kernel ran its scalar
variant there (the full-width paths' rows are 16-byte aligned: every
launch must take the bulk variant). The kernel checks include shapes and
views that reach both variants of all four kernels (``VARIANT_CASES``),
the feature screen's two variants giving the same bits on X and on a copy
of it off a 16-byte boundary, the margin
with no live row (``valid_m = 0``), the feature screen's dynamic
variant (sample weights, the gap-sphere cap, a NaN theta), its EDPP mode
(exact, inexact and degenerate anchors, a NaN theta, never above the VI
mode on the same anchor; timed in turns with the VI mode) and its weighted
EDPP mode (sample weights, never above the weighted VI launch; timed in
turns with it), and the feature
screen's optional ``d_theta`` output (against the plain ``d_theta``, with
bounds equal bit for bit to a launch without it). Every phase
prints one JSON line; any failed check raises and the script exits
non-zero. The last lines are the ``{"kernels": [...]}`` record (times on
this card, bounds, launch counts) and ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero before printing any result.

TF32 is off for every float32 matmul and convolution: the certificate
(``core/dual.py``) and the Lipschitz estimate use ``torch.mv``, and TF32
there would loosen delta.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 on the tensor cores, dense
EPS32 = float(np.finfo(np.float32).eps)
FULL = dict(m=50_000, n=10_000, density=1.0, seed=0)
N_LAMBDAS, LAM_MIN_RATIO, SAFETY_STEPS = 8, 0.1, 4
BATCH_FIXED_ITERS = 60  # batched against single-path: FISTA iterations a step
BATCH_RATIOS = (0.1, 0.15, 0.2, 0.3)  # the 4 grids of the batched phase
COMPOSITE_RATIO = 0.02  # a deep grid: the sample rule screens from step 4 on
SCREEN_EVERY = 50       # dynamic paths: a refresh every 50 FISTA iterations
RAGGED = [(64, 64), (128, 256), (300, 200), (513, 130)]
# shapes and views that reach each variant of the redesigned kernels:
# (m, n, offset rows): bf16 n % 8 != 0 with fp32 n % 4 == 0, an aligned
# view X[1:], an odd-n view X[1:], and rows wider than one staged v chunk
# (16,384 columns), aligned and not
VARIANT_CASES = [(128, 260, 0), (300, 200, 1), (301, 203, 1), (96, 20000, 0),
                 (40, 20001, 0)]
# sample-surplus kernel cases: (secant history, trust radii dw, db)
SURPLUS_CASES = [(False, math.inf, math.inf), (True, math.inf, math.inf),
                 (False, 0.37, 0.05), (True, 0.37, 0.05)]
# feature-screen dynamic variant cases: (sample weights, gap-sphere cap)
DYNAMIC_CASES = [(False, True), (True, False), (True, True)]
CHUNK_M = 2048  # out-of-core phases: feature rows per chunk
# the feature screen's launches, each counted by variant (kernels/screen.py)
SCREEN_KERNELS = ("screen_bounds", "screen_bounds_dynamic", "screen_bounds_edpp",
                  "screen_bounds_edpp_weighted", "screen_partial")
# LIBSVM's news20.binary: features, samples, nonzeros
NEWS20 = dict(m=1_355_191, n=19_996, nnz=9_097_916)
NEWS20_RATIO = 0.3  # the news20-shaped path's lam_min_ratio (8 lambdas)
# the news20-shaped phase estimates L over the store re-sliced at 65,536 rows
# a chunk (21 chunks): at CHUNK_M (662 chunks) one stream of X costs ~0.5 ms
# a chunk, most of it host overhead, and the 100-iteration estimate ~35 s
# (NVIDIA H100 80GB HBM3 at 700 W)
LIP_CHUNK_M = 65_536
VECTORS = 32  # the O(m + n) fp32 vectors the peak-memory limit allows
# the sharded phases: FISTA iterations a step (no stop rule), the grids, the
# bench instance's grid and iterations, and the tolerances
GRID_ITERS = 50
GRIDS = ((2, 2), (4, 1), (1, 4))
GRID_SMALL = dict(n_lambdas=6, lam_min_ratio=0.05, max_iters=60, tol=-1.0)
GRID_SMALL_COMPOSITE = dict(n_lambdas=6, lam_min_ratio=0.02, max_iters=60, tol=-1.0)
GRID_TIMEOUT_S = 600
# the host lane's options on a grid, on the bench instance (``host_lane_grid``):
# a shallow grid, where the feature rules screen (the 0.05 grid keeps all
# 2,000 features from step 1 on)
GRID_LANE = dict(n_lambdas=6, lam_min_ratio=0.3, max_iters=60, tol=-1.0)
GRID_LANES = {
    (2, 2): {"edpp": dict(rules="edpp", **GRID_LANE),
             "dvi": dict(rules="dvi", **GRID_LANE),
             "auto": dict(rules="auto", **GRID_LANE),
             "exact_lipschitz": dict(rules="feature_vi", exact_lipschitz=True,
                                     **GRID_LANE)},
    (1, 4): {"edpp": dict(rules="edpp", **GRID_LANE),
             "dvi": dict(rules="dvi", **GRID_LANE)},
}
# checkpoints, faults and tracing on the full-width feature path
STOP_STEP = 4     # the interrupted path stops in this step (after its solve)
TRACE_PAIRS = 20  # tracing off and on back to back, the order alternating
PROFILE_SHAPE = dict(m=20_000, n=4_000)  # the launcher's --profile captures


T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one phase's JSON line, with the seconds since the script began."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T_START, 3)}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def timed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph (after one eager warm-up call), one replay timed with CUDA
    events, over ``reps``. Unlike :func:`timed_ms` it leaves out the host's
    time per call (a wrapper's checks, allocations and launch), which at a
    small shape can be longer than the kernel's. ``fn`` must copy nothing
    from the host (a capture refuses it)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def screen_device_times(screen, X, y, theta, scalars, weights, edpp, name, reps,
                        want_d_theta=False) -> dict:
    """One feature-screen launch (its packed ``scalars`` given) and
    ``torch.mv(X, y theta)``, the one library call that reads the same bytes
    (it gives d_theta only), each by its device time (:func:`device_ms`);
    and the library call's time per call (:func:`timed_ms`)."""
    v = y * theta
    return {"device_ms": device_ms(lambda: screen._launch_features(
                X, y, theta, scalars, weights, edpp, name, want_d_theta), reps),
            "mv_ms": timed_ms(lambda: torch.mv(X, v), reps),
            "mv_device_ms": device_ms(lambda: torch.mv(X, v), reps)}


#: the rows of the feature screen's partial sums (``FeatureReductions``)
SCREEN_SUMS = ("d_theta", "d_one", "d_y", "d_sq")


def sums_error(got, want, scale, k: int) -> tuple:
    """Sums of k terms against their plain version, sum by sum: each error
    held to :func:`tolerance` at the size of its own terms, ``scale`` being
    the same sums taken over the terms' absolute values (a row of centred
    features sums to about 0, where the sum's own size says nothing of its
    rounding). Returns the largest error and the largest error over its
    tolerance."""
    err = (got.float() - want.float()).abs()
    tol = max(1e-5, 4 * EPS32 * math.sqrt(k)) * torch.clamp_min(scale.float().abs(), 1.0)
    return float(err.max()), float((err / tol).max())


def tolerance(k: int, scale: float) -> float:
    """Kernel vs plain version: the same fp32 sums of k terms taken in two
    orders; each carries rounding error ~eps * sqrt(k) of the output's
    scale. 4x headroom, floored at 1e-5 relative."""
    return max(1e-5, 4 * EPS32 * math.sqrt(k)) * max(1.0, scale)


class Kernels:
    """Runs each kernel against its plain version and keeps the worst error."""

    def __init__(self, hinge, screen, shared_scalars, stats, edpp_scalars, edpp_stats,
                 lam_max_fn, theta_fn):
        self.hinge, self.screen, self.shared_scalars = hinge, screen, shared_scalars
        self.stats = stats  # core/screening.shared_scalars_from_stats
        self.edpp_scalars = edpp_scalars  # core/screening.edpp_scalars
        self.edpp_stats = edpp_stats  # core/screening.edpp_scalars_from_stats
        self.lam_max, self.theta_max = lam_max_fn, theta_fn  # core/dual.py
        self.max_err = {"margin_obj": 0.0, "hinge_grad": 0.0, "screen_bounds": 0.0,
                        "screen_bounds_dynamic": 0.0, "screen_bounds_edpp": 0.0,
                        "screen_bounds_edpp_weighted": 0.0,
                        "sample_surplus": 0.0, "margin_partial": 0.0,
                        "screen_partial": 0.0, "sample_partial": 0.0}
        self.variants_seen = {name: set() for name in (
            "margin_obj", "hinge_grad", "sample_surplus", *SCREEN_KERNELS)}

    def _variant(self, name, counts, X, where):
        """The variant a kernel just launched: the bulk one exactly when
        X's rows are 16-byte aligned."""
        table = {**self.hinge.VARIANTS, **self.screen.VARIANTS}[name]
        launched = [v for v in table if table[v] > counts[v]]
        want = "bulk" if self.hinge.bulk_aligned(X) else "scalar"
        require(launched == [want], f"{name} {where}: launched {launched}, want {want}")
        self.variants_seen[name].add(want)
        return want

    def screen_variants(self, before, X, where) -> str:
        """Every feature-screen launch since ``before`` (a copy of the
        screen's variant counts) took the variant X's alignment allows."""
        want = "bulk" if self.hinge.bulk_aligned(X) else "scalar"
        for name in SCREEN_KERNELS:
            table = self.screen.VARIANTS[name]
            launched = [v for v in table if table[v] > before[name][v]]
            require(launched in ([], [want]), f"{name} {where}: launched {launched}, "
                                              f"want {want}")
            if launched:
                self.variants_seen[name].add(want)
        return want

    def screen_bits_across_variants(self, X, y, gen, where) -> dict:
        """The feature screen sums in one order in both variants: X and a
        copy of it one item off a 16-byte boundary (the scalar variant)
        give the same bits in the VI mode with its d_theta output, the
        dynamic variant, the EDPP and weighted EDPP modes and the weighted
        partial sums."""
        n = X.shape[1]
        sc = self.screen
        flat = torch.zeros(X.numel() + 1, dtype=X.dtype, device="cuda")
        flat[1:] = X.reshape(-1)
        Xs = flat[1:].view(X.shape)
        require(not self.hinge.bulk_aligned(Xs), f"screen {where}: the copy is aligned")
        s = (torch.rand(n, generator=gen) < 0.7).float().cuda()
        theta = (torch.rand(n, generator=gen) / 5.0).cuda()
        sh = self.shared_scalars(y, 5.0, 3.0, theta, delta=0.01)
        e = self.edpp_scalars(y, 5.0, 3.0, theta, delta=0.01)
        shw, ew = self.weighted_scalars(y, 5.0, 3.0, theta * s, 0.01, s)
        cap = torch.tensor(0.05, device="cuda")
        calls = {
            "vi_d_theta": lambda A: sc.screen_bounds_from_shared(A, y, theta, sh,
                                                                 want_d_theta=True),
            "dynamic": lambda A: (sc.screen_bounds_from_shared(A, y, theta * s, shw, s,
                                                               cap),),
            "edpp": lambda A: (sc.screen_bounds_edpp(A, y, theta, sh, e),),
            "edpp_weighted": lambda A: (sc.screen_bounds_edpp(A, y, theta * s, shw, ew,
                                                              weights=s),),
            "partial_weighted": lambda A: (sc.screen_partial_op(A, y, theta, s),)}
        out = {tag: all(torch.equal(p, q) for p, q in zip(call(X), call(Xs)))
               for tag, call in calls.items()}
        require(all(out.values()), f"screen {where}: the two variants' bits differ {out}")
        return out

    def _check(self, name, got, want, k, where):
        err = float((got.float() - want.float()).abs().max())
        tol = tolerance(k, float(want.float().abs().max()))
        self.max_err[name] = max(self.max_err[name], err)
        require(err <= tol, f"{name} {where}: max_abs_err {err:.3e} > tol {tol:.3e}")
        return {"max_abs_err": err, "tol": tol}

    def _check_rows(self, name, got, want, scale, k, where, rows):
        """A partial mode's stacked sums, row by row and sum by sum
        (:func:`sums_error`)."""
        out = {}
        for row, g, p, sc in zip(rows, got, want, scale, strict=True):
            err, ratio = sums_error(g, p, sc, k)
            self.max_err[name] = max(self.max_err[name], err)
            require(ratio <= 1.0, f"{name} {where} {row}: max_abs_err {err:.3e} is "
                                  f"{ratio:.2f} x its tolerance")
            out[row] = {"max_abs_err": err, "err_over_tol": ratio}
        return out

    def margin(self, X, w, y, b, vm, where):
        h = self.hinge
        before = dict(h.VARIANTS["margin_obj"])
        got = h.margin_obj_op(X, w, y, b, vm)
        variant = self._variant("margin_obj", before, X, where)
        want = h.margin_obj_plain(X, w, y, b, vm)
        torch.cuda.synchronize()
        if vm == 0:  # no live row: nothing is read
            require(bool((got[0] == 0).all()), f"margin_obj {where}: u not 0")
        # u sums vm terms; xi inherits u's error; the loss sums n terms
        k = vm + X.shape[1]
        out = {part: self._check("margin_obj", g, p, k, f"{where} {part}")
               for part, g, p in zip(("u", "xi", "loss"), got, want)}
        return {**out, "variant": variant}

    def grad(self, X, y, xi, vm, where):
        before = dict(self.hinge.VARIANTS["hinge_grad"])
        got = self.hinge.hinge_grad_op(X, y, xi, vm)
        variant = self._variant("hinge_grad", before, X, where)
        want = self.hinge.hinge_grad_plain(X, y, xi, vm)
        torch.cuda.synchronize()
        out = self._check("hinge_grad", got, want, X.shape[1], where)
        require(bool((got[vm:] == 0).all()), f"hinge_grad {where}: rows past valid_m not 0")
        return {**out, "variant": variant}

    def bounds(self, X, y, theta, sh, where):
        got = self.screen.screen_bounds_from_shared(X, y, theta, sh)
        want = self.screen.screen_bounds_plain(X, y, theta, sh)
        torch.cuda.synchronize()
        return self._check("screen_bounds", got, want, X.shape[1], where)

    def d_theta(self, X, y, gen, where):
        """The feature screen's optional d_theta output, in the VI mode and
        the dynamic variant: against the plain d_theta at the bound check's
        tolerance (k = n terms), with the bounds bit for bit those of the
        launch without the output."""
        n = X.shape[1]
        sc = self.screen
        s = (torch.rand(n, generator=gen) < 0.7).float().cuda()
        theta = (torch.rand(n, generator=gen) / 5.0).cuda()
        out = {}
        for tag, th, sh, w, cap in (
                ("vi", theta, self.shared_scalars(y, 5.0, 3.0, theta, delta=0.01),
                 None, None),
                ("dynamic", theta * s, self.dynamic_shared(y, 5.0, theta * s, 0.05, s),
                 s, torch.tensor(0.05, device="cuda"))):
            bounds, d_theta = sc.screen_bounds_from_shared(X, y, th, sh, w, cap,
                                                           want_d_theta=True)
            plain = sc.screen_bounds_from_shared(X, y, th, sh, w, cap)
            _, want = sc.screen_bounds_plain(X, y, th, sh, w, cap, want_d_theta=True)
            torch.cuda.synchronize()
            require(torch.equal(bounds, plain),
                    f"screen d_theta {where} {tag}: bounds moved with the output")
            out[tag] = self._check("screen_bounds", d_theta, want, n, f"{where} d_theta {tag}")
        return out

    def dynamic_shared(self, y, lam, theta, delta, weights):
        """The at-lambda region's scalars from the weighted statistics, as
        ``core/solver.py`` ``refresh_bounds`` builds them."""
        return self.weighted_scalars(y, lam, lam, theta, delta, weights)[0]

    def weighted_scalars(self, y, lam1, lam2, theta, delta, weights):
        """The VI and EDPP scalars of the region anchored at ``theta`` over
        the live samples ``weights`` (all without): ``one_y = y.s``,
        ``n_tot = sum(s)``, as the scan engines' sample-masked steps build
        them (``path_scan._region_stats``)."""
        s = torch.ones_like(y) if weights is None else weights
        kw = dict(lam1=torch.tensor(lam1, device=y.device),
                  lam2=torch.tensor(lam2, device=y.device), one_y=torch.sum(y * s),
                  theta_dot_one=theta.sum(), theta_dot_y=theta @ y,
                  theta_sq=theta @ theta, n_tot=s.sum(),
                  delta=torch.tensor(delta, device=y.device))
        return self.stats(**kw), self.edpp_stats(**kw)

    def edpp_weighted(self, X, y, gen, where):
        """The feature screen's weighted EDPP mode (the path server's
        sample-masked slots) against its plain version (the ``edpp`` rule
        program over the weighted reductions), with a 0/1 mask of ~70% live
        samples, on the exact anchor at the live problem's lam_max and an
        inexact one (delta 0.02), the scalars from the weighted statistics.
        On both the bound is at most the weighted VI launch's on the same
        anchor, bit for bit; a NaN theta gives NaN bounds. Each launch must
        count as ``screen_bounds_edpp_weighted``. The sums have k = n
        terms."""
        n = X.shape[1]
        sc = self.screen
        s = (torch.rand(n, generator=gen) < 0.7).float().cuda()
        b = torch.sum(y * s) / torch.sum(s)  # the live problem's bias at lam_max
        lmax = float(torch.max(torch.abs(torch.mv(X.float(), (y - b) * s))))
        exact = (1.0 - y * b) / lmax * s
        inexact = (torch.rand(n, generator=gen) / (0.7 * lmax)).cuda() * s
        out = {}

        def run(theta, lam1, delta, kind):
            sh, e = self.weighted_scalars(y, lam1, 0.5 * lam1, theta, delta, s)
            before = sc.LAUNCHES["screen_bounds_edpp_weighted"]
            got = sc.screen_bounds_edpp(X, y, theta, sh, e, weights=s)
            require(sc.LAUNCHES["screen_bounds_edpp_weighted"] == before + 1,
                    f"screen_bounds_edpp_weighted {where} {kind}: not counted")
            want = sc.screen_bounds_edpp_plain(X, y, theta, sh, e, s)
            vi = sc.screen_bounds_from_shared(X, y, theta, sh, weights=s)
            torch.cuda.synchronize()
            return got, want, vi

        for kind, theta, lam1, delta in (("exact", exact, lmax, 0.0),
                                         ("inexact", inexact, 0.7 * lmax, 0.02)):
            got, want, vi = run(theta, lam1, delta, kind)
            res = self._check("screen_bounds_edpp_weighted", got, want, n, f"{where} {kind}")
            require(bool((got <= vi).all()),
                    f"screen_bounds_edpp_weighted {where} {kind}: above weighted VI")
            res["below_vi"] = int((got < vi).sum())
            out[kind] = res
        bad = inexact.clone()
        bad[int(torch.nonzero(s)[0])] = float("nan")
        got, want, _ = run(bad, 0.7 * lmax, 0.01, "nan theta")
        require(bool(torch.isnan(got).all()) and bool(torch.isnan(want).all()),
                f"screen_bounds_edpp_weighted {where}: a NaN theta did not propagate")
        out["nan_theta"] = "all NaN"
        return out

    def serve_slot(self, server, buffers, gen, where) -> dict:
        """The path server's kernels at the shapes its steps gave them, on
        what its last step left on the card: slot 0 of the group's padded
        buffer (its last tenant's X, y and live-sample mask, and the anchor
        its carry holds) through the margin and gradient kernels over every
        row, as a mask-mode step runs them (the carried w and b), and
        through the weighted VI and EDPP screens from that anchor; the
        group's largest compact buffer (``buffers``: its last contents)
        through the margin and gradient kernels with every row valid, as a
        compact step runs them. Each is held against its plain version at
        :func:`tolerance`, the weighted EDPP bound at most the weighted VI
        one, and each is timed beside its plain version and the one library
        call, with the bytes and operations of its bound. Returns
        ``{"checks": ..., "timing": {kernel: [per shape]}}``."""
        h, sc = self.hinge, self.screen
        X, y, s = server._X[0], server._y[0], server._sm[0]
        w_c, b_c, theta, delta, lam1 = (t[0] for t in server._carry[:5])
        m, n = X.shape
        require(bool(torch.isfinite(delta)), f"serve slot {where}: the anchor is refused")
        checks, timing = {}, {}
        reps = 20

        def hinge_pair(Xk, w, vm, tag):
            checks[f"margin_obj {tag}"] = self.margin(Xk, w, y, b_c, vm, f"{where} {tag}")
            _, xi, _ = h.margin_obj_plain(Xk, w, y, b_c, vm)
            checks[f"hinge_grad {tag}"] = self.grad(Xk, y, xi, vm, f"{where} {tag}")
            rows, v = Xk.shape[0], y * xi
            timing.setdefault("margin_obj", []).append({
                "shape": [rows, n, vm], "step": tag,
                "ms": timed_ms(lambda: h.margin_obj_op(Xk, w, y, b_c, vm), reps),
                "plain_ms": timed_ms(lambda: h.margin_obj_plain(Xk, w, y, b_c, vm), reps),
                "library_ms": timed_ms(lambda: torch.mv(Xk[:vm].t(), w[:vm]), reps),
                "bytes": vm * n * 4 + vm * 4 + n * 4 + 4 + 2 * n * 4 + 4,
                "flops": 2 * vm * n + 5 * n})
            timing.setdefault("hinge_grad", []).append({
                "shape": [rows, n, vm], "step": tag,
                "ms": timed_ms(lambda: h.hinge_grad_op(Xk, y, xi, vm), reps),
                "plain_ms": timed_ms(lambda: h.hinge_grad_plain(Xk, y, xi, vm), reps),
                "library_ms": timed_ms(lambda: torch.mv(Xk[:vm], v), reps),
                "bytes": vm * n * 4 + 2 * n * 4 + rows * 4,
                "flops": 2 * vm * n + n})

        hinge_pair(X, w_c, m, "mask-mode slot")
        if buffers:
            buf = max(buffers, key=lambda b: b.shape[0])
            cap = buf.shape[0]
            w = (torch.randn(cap, generator=gen) * 0.01).cuda()
            hinge_pair(buf, w, cap, "compact buffer")
        lam1 = float(lam1)
        sh, e = self.weighted_scalars(y, lam1, 0.9 * lam1, theta, float(delta), s)

        def vi():
            return sc.screen_bounds_from_shared(X, y, theta, sh, weights=s)

        def edpp():
            return sc.screen_bounds_edpp(X, y, theta, sh, e, weights=s)

        got_v, got_e = vi(), edpp()
        want_v = sc.screen_bounds_plain(X, y, theta, sh, s)
        want_e = sc.screen_bounds_edpp_plain(X, y, theta, sh, e, s)
        torch.cuda.synchronize()
        checks["screen weighted vi"] = self._check("screen_bounds_dynamic", got_v, want_v,
                                                   n, f"{where} weighted vi")
        checks["screen weighted edpp"] = self._check(
            "screen_bounds_edpp_weighted", got_e, want_e, n, f"{where} weighted edpp")
        require(bool((got_e <= got_v).all()),
                f"serve slot {where}: weighted EDPP above weighted VI")
        checks["screen weighted edpp"]["below_vi"] = int((got_e < got_v).sum())
        turns = [timed_ms(f, reps) for f in (vi, edpp, edpp, vi)]
        packed = {False: sc.pack_shared(sh), True: sc.pack_shared(sh, edpp=e)}
        names = {False: "screen_bounds_dynamic", True: "screen_bounds_edpp_weighted"}
        dturns = [device_ms(lambda: sc._launch_features(X, y, theta, packed[f], s, f,
                                                        names[f]), reps)
                  for f in (False, True, True, False)]
        mv = screen_device_times(sc, X, y, theta, packed[False], s, False, names[False],
                                 reps)
        for name, plain, ms, dms, extra in (
                ("screen_bounds_dynamic",
                 lambda: sc.screen_bounds_plain(X, y, theta, sh, s),
                 0.5 * (turns[0] + turns[3]), 0.5 * (dturns[0] + dturns[3]), 70),
                ("screen_bounds_edpp_weighted",
                 lambda: sc.screen_bounds_edpp_plain(X, y, theta, sh, e, s),
                 0.5 * (turns[1] + turns[2]), 0.5 * (dturns[1] + dturns[2]), 80)):
            timing[name] = [{
                "shape": [m, n, m], "step": "slot", "ms": ms, "device_ms": dms,
                "mv_ms": mv["mv_ms"], "mv_device_ms": mv["mv_device_ms"],
                "plain_ms": timed_ms(plain, reps), "library_ms": None,
                "bytes": m * n * 4 + 3 * n * 4 + 64 + m * 4,
                "flops": 8 * m * n + 2 * n + extra * m,
                "live_samples": int(s.sum()), "order": "vi, edpp, edpp, vi"}]
        for rows in timing.values():
            for t in rows:
                t.update(zip(("bound_ms", "bound_by"), bound_of(t)))
        return {"checks": checks, "timing": timing}

    def _check_nonfinite(self, name, got, want, k, where):
        """Kernel vs plain where some outputs are NaN or inf: the same
        entries must be NaN, the same +-inf, and the finite ones close."""
        require(torch.equal(torch.isnan(got), torch.isnan(want)),
                f"{name} {where}: NaN entries differ")
        inf = torch.isinf(want)
        require(torch.equal(torch.isinf(got), inf)
                and torch.equal(got[inf], want[inf]), f"{name} {where}: inf entries differ")
        fin = torch.isfinite(want)
        if bool(fin.any()):
            return self._check(name, got[fin], want[fin], k, where)
        return {"max_abs_err": 0.0, "finite": 0}

    def dynamic(self, X, y, gen, where):
        """The feature screen's dynamic variant in every DYNAMIC_CASES case
        at delta 0.05, then with delta = inf (the sphere term is inf or
        NaN) and with a NaN theta, which must give NaN bounds. Each launch
        must count as ``screen_bounds_dynamic``. The sums have k = n terms."""
        n = X.shape[1]
        sc = self.screen
        s = (torch.rand(n, generator=gen) < 0.7).float().cuda()
        theta = (torch.rand(n, generator=gen) / 5.0).cuda() * s
        out = {}

        def run(th, delta, weights, cap, tag):
            sh = self.dynamic_shared(y, 5.0, th, delta, weights)
            cap_delta = torch.tensor(delta, device="cuda") if cap else None
            before = sc.LAUNCHES["screen_bounds_dynamic"]
            got = sc.screen_bounds_from_shared(X, y, th, sh, weights, cap_delta)
            require(sc.LAUNCHES["screen_bounds_dynamic"] == before + 1,
                    f"screen_bounds_dynamic {where} {tag}: not counted")
            want = sc.screen_bounds_plain(X, y, th, sh, weights, cap_delta)
            torch.cuda.synchronize()
            return got, want

        for weighted, cap in DYNAMIC_CASES:
            tag = f"weights={weighted} cap={cap}"
            got, want = run(theta, 0.05, s if weighted else None, cap, tag)
            out[tag] = self._check("screen_bounds_dynamic", got, want, n, f"{where} {tag}")
        got, want = run(theta, math.inf, s, True, "delta=inf")
        out["delta=inf"] = self._check_nonfinite("screen_bounds_dynamic", got, want, n,
                                                 f"{where} delta=inf")
        bad = theta.clone()
        bad[n // 2] = float("nan")
        got, want = run(bad, math.inf, s, True, "nan theta")
        require(bool(torch.isnan(got).all()) and bool(torch.isnan(want).all()),
                f"screen_bounds_dynamic {where}: a NaN theta did not propagate")
        out["nan_theta"] = "all NaN"
        return out

    def edpp(self, X, y, gen, where):
        """The feature screen's EDPP mode against its plain version (the
        ``edpp`` rule program over the four reductions) on three anchors: the
        exact one at lam_max with unbalanced classes, an inexact one (delta
        0.02), and alternating (balanced) classes at lam_max (v1 = 0 up to
        rounding: where the fallback fires, the bound is the VI bound up to
        rounding). On every anchor the
        bound is at most a VI-mode launch's on the same anchor, bit for bit;
        a NaN theta gives NaN bounds. Each launch must count as
        ``screen_bounds_edpp``. The sums have k = n terms."""
        n = X.shape[1]
        sc = self.screen
        unbalanced = y.clone()
        unbalanced[: n // 5] = 1.0
        balanced = torch.where(torch.arange(n, device="cuda") % 2 == 0, 1.0, -1.0)
        out = {}
        anchors = ((unbalanced, "exact"), (y, "inexact"), (balanced, "balanced"))
        for yy, kind in anchors:
            lmax = float(self.lam_max(X.float(), yy))
            theta, lam1, delta = self.theta_max(yy, lmax), lmax, 0.0
            if kind == "inexact":
                lam1, delta = 0.7 * lmax, 0.02
                theta = (torch.rand(n, generator=gen) / lam1).cuda()
            sh = self.shared_scalars(yy, lam1, 0.5 * lam1, theta, delta=delta)
            e = self.edpp_scalars(yy, lam1, 0.5 * lam1, theta, delta=delta)
            before = sc.LAUNCHES["screen_bounds_edpp"]
            got = sc.screen_bounds_edpp(X, yy, theta, sh, e)
            require(sc.LAUNCHES["screen_bounds_edpp"] == before + 1,
                    f"screen_bounds_edpp {where} {kind}: not counted")
            want = sc.screen_bounds_edpp_plain(X, yy, theta, sh, e)
            vi = sc.screen_bounds_from_shared(X, yy, theta, sh)
            torch.cuda.synchronize()
            res = self._check("screen_bounds_edpp", got, want, n, f"{where} {kind}")
            require(bool((got <= vi).all()), f"screen_bounds_edpp {where} {kind}: above VI")
            res["below_vi"] = int((got < vi).sum())
            res["degenerate"] = float(e.mu) == 0.0
            if res["degenerate"]:  # the DPP ball: the VI bound up to rounding
                self._check("screen_bounds_edpp", got, vi, n, f"{where} {kind} vs VI")
            out[kind] = res
        bad = theta.clone()
        bad[n // 2] = float("nan")
        sh = self.shared_scalars(balanced, 3.0, 2.0, bad, delta=0.01)
        e = self.edpp_scalars(balanced, 3.0, 2.0, bad, delta=0.01)
        got = sc.screen_bounds_edpp(X, balanced, bad, sh, e)
        want = sc.screen_bounds_edpp_plain(X, balanced, bad, sh, e)
        require(bool(torch.isnan(got).all()) and bool(torch.isnan(want).all()),
                f"screen_bounds_edpp {where}: a NaN theta did not propagate")
        out["nan_theta"] = "all NaN"
        return out

    def partial(self, X, w, y, gen, where):
        """The partial modes: each one's sums against its plain version
        (the bound check's tolerance: the margin's and the sample's k = m
        terms, the screen's k = n, weighted too), and a partial launch then
        its finalize on the unsplit X bit for bit the full launch (the
        margin, the sample surplus, the screen's VI, dynamic and EDPP
        modes, and its weighted VI and weighted EDPP launches)."""
        h, sc = self.hinge, self.screen
        m, n = X.shape
        theta = (torch.rand(n, generator=gen) / 5.0).cuda()
        s = (torch.rand(n, generator=gen) < 0.7).float().cuda()
        b = torch.tensor(0.2, device="cuda")
        sh = self.shared_scalars(y, 5.0, 3.0, theta, delta=0.01)
        e = self.edpp_scalars(y, 5.0, 3.0, theta, delta=0.01)
        shd = self.dynamic_shared(y, 5.0, theta * s, 0.05, s)
        shw, ew = self.weighted_scalars(y, 5.0, 3.0, theta * s, 0.01, s)
        cap = torch.tensor(0.05, device="cuda")
        u_part, pair = h.margin_partial_op(X, w), sc.sample_partial_op(X, w)
        sums, sums_w = sc.screen_partial_op(X, y, theta), sc.screen_partial_op(
            X, y, theta * s, s)
        out = {
            "margin_partial": self._check("margin_partial", u_part,
                                          h.margin_partial_plain(X, w), m, where),
            "sample_partial": self._check_rows(
                "sample_partial", pair, sc.sample_partial_plain(X, w),
                sc.sample_partial_plain(X.abs(), w.abs()), m, where, ("x_w", "x_sq")),
            "screen_partial": self._check_rows(
                "screen_partial", sums, sc.screen_partial_plain(X, y, theta),
                sc.screen_partial_plain(X.abs(), y.abs(), theta.abs()), n, where,
                SCREEN_SUMS),
            "screen_partial_weighted": self._check_rows(
                "screen_partial", sums_w, sc.screen_partial_plain(X, y, theta * s, s),
                sc.screen_partial_plain(X.abs(), y.abs(), (theta * s).abs(), s), n,
                where, SCREEN_SUMS)}
        bits = {
            "margin": all(torch.equal(p, q) for p, q in zip(
                h.margin_obj_op(X, w, y, b), h.margin_finalize_op(u_part, y, b))),
            "sample": all(torch.equal(p, q) for p, q in zip(
                sc.sample_surplus_op(X, w, y, 0.13, 0.37, 0.05),
                sc.sample_finalize_op(pair, y, 0.13, 0.37, 0.05))),
            "screen_vi": torch.equal(sc.screen_bounds_from_shared(X, y, theta, sh),
                                     sc.screen_finalize_op(sums, sh)),
            "screen_dynamic": torch.equal(
                sc.screen_bounds_from_shared(X, y, theta * s, shd, s, cap),
                sc.screen_finalize_op(sums_w, shd, cap_delta=cap)),
            "screen_edpp": torch.equal(sc.screen_bounds_edpp(X, y, theta, sh, e),
                                       sc.screen_finalize_op(sums, sh, edpp=e)),
            "screen_weighted_vi": torch.equal(
                sc.screen_bounds_from_shared(X, y, theta * s, shw, s),
                sc.screen_finalize_op(sums_w, shw)),
            "screen_edpp_weighted": torch.equal(
                sc.screen_bounds_edpp(X, y, theta * s, shw, ew, weights=s),
                sc.screen_finalize_op(sums_w, shw, edpp=ew)),
        }
        require(all(bits.values()), f"partial modes {where}: finalize != full launch {bits}")
        out["bitwise_vs_full"] = bits
        return out

    def surplus(self, X, w1, y, gen, where):
        """The sample-surplus kernel in every SURPLUS_CASES case: the
        surplus and the margins u it returns. Both sum k = m terms."""
        out = {}
        for hist, dw, db in SURPLUS_CASES:
            u_prev = torch.randn(X.shape[1], generator=gen).cuda() if hist else None
            args = (X, w1, y, 0.13, dw, db, u_prev)
            tag = f"hist={hist} dw={dw}"
            before = dict(self.screen.VARIANTS["sample_surplus"])
            got = self.screen.sample_surplus_op(*args)
            out[f"{tag} variant"] = self._variant("sample_surplus", before, X,
                                                  f"{where} {tag}")
            want = self.screen.sample_surplus_plain(*args)
            torch.cuda.synchronize()
            for part, g, p in zip(("surplus", "u"), got, want):
                out[f"{tag} {part}"] = self._check(
                    "sample_surplus", g, p, X.shape[0], f"{where} {tag} {part}")
        return out


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    info = {"phase": "device", "name": name, "nvidia_smi": smi_line,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "allow_tf32": False}
    emit(info)
    return info


def phase_build(build) -> None:
    """Build the kernels; report each kernel (mangled name), its registers,
    shared memory and spills from ``-Xptxas -v``."""
    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    ptxas = [ln.split("'")[1] if "Compiling entry function" in ln else ln.strip()
             for ln in build.build_log().splitlines()
             if "Compiling entry function" in ln or "registers" in ln
             or "spill" in ln or ln.startswith("==")]
    emit({"phase": "build", "seconds": secs, "library": build.library_path().name,
          "ptxas": ptxas})


def phase_kernels_ragged(K, gen) -> None:
    """Every kernel at the ragged test shapes and the variant cases, fp32
    and bf16, valid_m < m (the margin also at valid_m = 0); each redesigned
    kernel must take the variant its input's alignment allows, both
    variants of each must run, and the feature screen's two variants must
    give the same bits."""
    for m, n, off in [(m, n, 0) for m, n in RAGGED] + VARIANT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            X = torch.randn(m + off, n, generator=gen).to("cuda", dtype)[off:]
            w = torch.randn(m, generator=gen).cuda()
            y = torch.where(torch.rand(n, generator=gen) < 0.6, 1.0, -1.0).cuda()
            xi = torch.rand(n, generator=gen).cuda()
            b = torch.tensor(0.2, device="cuda")
            res = {"margin_vm0": K.margin(X, w, y, b, 0, f"{m}x{n} {dtype} vm=0")}
            for vm in (1, 37, m):
                res[f"margin_vm{vm}"] = K.margin(X, w, y, b, vm, f"{m}x{n} {dtype} vm={vm}")
                res[f"grad_vm{vm}"] = K.grad(X, y, xi, vm, f"{m}x{n} {dtype} vm={vm}")
            theta = (torch.rand(n, generator=gen) / 5.0).cuda()
            sh = K.shared_scalars(y, 5.0, 3.0, theta, delta=0.01)
            before = {k: dict(K.screen.VARIANTS[k]) for k in SCREEN_KERNELS}
            res["screen"] = K.bounds(X, y, theta, sh, f"{m}x{n} {dtype}")
            res["screen_dynamic"] = K.dynamic(X, y, gen, f"{m}x{n} {dtype}")
            res["screen_edpp"] = K.edpp(X, y, gen, f"{m}x{n} {dtype}")
            res["screen_edpp_weighted"] = K.edpp_weighted(X, y, gen, f"{m}x{n} {dtype}")
            res["screen_d_theta"] = K.d_theta(X, y, gen, f"{m}x{n} {dtype}")
            res["sample_surplus"] = K.surplus(X, w, y, gen, f"{m}x{n} {dtype}")
            res["partial_modes"] = K.partial(X, w, y, gen, f"{m}x{n} {dtype}")
            res["screen_variant"] = K.screen_variants(before, X, f"{m}x{n} {dtype}")
            res["screen_variants_bitwise"] = K.screen_bits_across_variants(
                X, y, gen, f"{m}x{n} {dtype}")
            emit({"phase": "kernels_ragged", "shape": [m, n], "row_offset": off,
                  "dtype": str(dtype), "bulk_aligned": K.hinge.bulk_aligned(X),
                  "checks": res})
    for name, seen in K.variants_seen.items():
        require(seen == {"bulk", "scalar"}, f"{name}: variants run {sorted(seen)}")


def phase_kernels_full(K, X, y, gen, lam_max_fn, theta_fn) -> None:
    """Every kernel at the full-width shape, fp32 and bf16, with valid_m < m."""
    m, n = X.shape
    w = (torch.randn(m, generator=gen) * 0.01).cuda()
    xi = torch.rand(n, generator=gen).cuda()
    b = torch.tensor(0.1, device="cuda")
    lmax = float(lam_max_fn(X, y))
    theta = theta_fn(y, lmax)
    sh = K.shared_scalars(y, lmax, 0.5 * lmax, theta, delta=1e-3)
    for dtype in (torch.float32, torch.bfloat16):
        Xd = X if dtype == torch.float32 else X.to(dtype)
        res = {}
        for vm in (m // 3, m):
            res[f"margin_vm{vm}"] = K.margin(Xd, w, y, b, vm, f"full {dtype} vm={vm}")
            res[f"grad_vm{vm}"] = K.grad(Xd, y, xi, vm, f"full {dtype} vm={vm}")
        res["screen"] = K.bounds(Xd, y, theta, sh, f"full {dtype}")
        res["screen_dynamic"] = K.dynamic(Xd, y, gen, f"full {dtype}")
        res["screen_edpp"] = K.edpp(Xd, y, gen, f"full {dtype}")
        res["screen_edpp_weighted"] = K.edpp_weighted(Xd, y, gen, f"full {dtype}")
        res["screen_d_theta"] = K.d_theta(Xd, y, gen, f"full {dtype}")
        res["sample_surplus"] = K.surplus(Xd, w, y, gen, f"full {dtype}")
        res["partial_modes"] = K.partial(Xd, w, y, gen, f"full {dtype}")
        require(res["margin_vm%d" % m]["variant"] == "bulk"
                and res["grad_vm%d" % m]["variant"] == "bulk"
                and res["sample_surplus"]["hist=True dw=0.37 variant"] == "bulk",
                f"full {dtype}: the redesigned kernels did not take the bulk variant")
        # the stop rule ties on fp32 plateaus: a repeated call must give the
        # same bits (fixed summation order, no float atomics)
        vm = m // 3
        u_prev = torch.randn(n, generator=gen).cuda()
        s = (torch.rand(n, generator=gen) < 0.7).float().cuda()
        sh_d = K.dynamic_shared(y, lmax, theta * s, 1e-3, s)
        cap = torch.tensor(1e-3, device="cuda")
        e = K.edpp_scalars(y, lmax, 0.5 * lmax, theta, delta=1e-3)
        sh_w, e_w = K.weighted_scalars(y, lmax, 0.5 * lmax, theta * s, 1e-3, s)
        for name, call in (
                ("margin_obj", lambda: K.hinge.margin_obj_op(Xd, w, y, b, vm)),
                ("hinge_grad", lambda: (K.hinge.hinge_grad_op(Xd, y, xi, vm),)),
                ("screen_bounds",
                 lambda: (K.screen.screen_bounds_from_shared(Xd, y, theta, sh),)),
                ("screen_bounds_dynamic",
                 lambda: (K.screen.screen_bounds_from_shared(
                     Xd, y, theta * s, sh_d, s, cap),)),
                ("screen_bounds_edpp",
                 lambda: (K.screen.screen_bounds_edpp(Xd, y, theta, sh, e),)),
                ("screen_bounds_edpp_weighted",
                 lambda: (K.screen.screen_bounds_edpp(Xd, y, theta * s, sh_w, e_w,
                                                      weights=s),)),
                ("sample_surplus", lambda: K.screen.sample_surplus_op(
                    Xd, w, y, 0.13, 0.37, 0.05, u_prev))):
            first, again = call(), call()
            require(all(torch.equal(p, q) for p, q in zip(first, again)),
                    f"{name} {dtype}: a repeated call gave different bits")
        res["bitwise_repeat"] = True
        emit({"phase": "kernels_full", "shape": [m, n], "dtype": str(dtype),
              "checks": res})
        del Xd


def require_bulk(ops, launches, names, where, variants=None) -> dict:
    """Every launch of each redesigned kernel in a full-width path took the
    bulk variant (the path's X, gather buffers and masks are aligned): the
    kernels ``names`` and every feature-screen launch of the run.
    ``variants``: the variant counts of the run (default: the current
    ones)."""
    variants = ops.variant_counts() if variants is None else variants
    names = (*names, *(k for k in SCREEN_KERNELS if launches.get(k, 0)))
    for name in names:
        v = variants[name]
        require(v["bulk"] > 0 and v["bulk"] == launches[name],
                f"{where}: {name} launched {launches[name]} times, bulk {v}")
    return variants


def phase_path(svm_path, ops, X, y) -> tuple:
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = svm_path(X, y, n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO,
                   device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = ops.launch_counts()
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds")),
            f"a kernel of the path was never launched: {launches}")
    variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad"), "feature path")
    require(bool(np.all(np.isfinite(res.objectives))), "non-finite objective")
    require(not np.any(res.extras["health"]), f"guard trips {res.extras['health']}")
    solve_s = res.extras["solve_times"]
    per_iter = [float(solve_s[k] / res.solver_iters[k]) if res.solver_iters[k] else None
                for k in range(len(res.lambdas))]
    emit({"phase": "path", "shape": [int(X.shape[0]), int(X.shape[1])],
          "lambdas": res.lambdas.tolist(), "kept": res.kept.tolist(),
          "active": res.active.tolist(), "iters": res.solver_iters.tolist(),
          "objectives": res.objectives.tolist(),
          "wall_s": res.wall_times.tolist(), "screen_s": res.screen_times.tolist(),
          "solve_s": solve_s.tolist(), "solve_s_per_iter": per_iter,
          "path_wall_s": total, "launches": launches, "variants": variants})
    return res, launches


def phase_objective_check(res, X, y, phase="objective_f64") -> None:
    """Objectives against a float64 recomputation from the returned (w, b)."""
    Xd, yd = X.double(), y.double()
    rel = []
    for k in range(len(res.lambdas)):
        w = torch.from_numpy(res.weights[k]).cuda()
        xi = torch.clamp_min(1.0 - yd * (Xd.t() @ w + res.biases[k]), 0.0)
        obj = float(0.5 * (xi * xi).sum() + res.lambdas[k] * w.abs().sum())
        rel.append(abs(obj - res.objectives[k]) / abs(obj))
    del Xd
    require(max(rel) <= 1e-4, f"objective vs float64 recomputation: rel {max(rel):.3e}")
    emit({"phase": phase, "max_rel": max(rel), "tol": 1e-4})


def phase_small_vs_plain(PathDriver, lipschitz_estimate, make) -> None:
    """The 2000 x 400 bench instance on the card (kernels) and on the CPU
    (plain versions), with the same L.

    Checked: with the stop rule out of play (``tol=-1``: exactly 300 FISTA
    iterations per step) both paths reach the fp32 floor, and per-step
    objectives agree to rel 1e-6 (on the CPU, runs whose L differs by 3e-7
    agree to 1.5e-7 this way). Reported only: the default-tolerance paths.
    Their stop rule (three exact fp32 ties) can stall a solve ~1e-5 above
    the optimum, and any change of rounding moves where it stalls."""
    ds = make(m=2000, n=400, seed=11)
    L = float(lipschitz_estimate(torch.from_numpy(ds.X)))
    grid = dict(n_lambdas=10, lam_min_ratio=0.05)
    out = {"phase": "bench_card_vs_cpu", "shape": [2000, 400], "tol_fixed_iters": 1e-6}
    for label, kw in (("default_tol", {}), ("fixed_iters", dict(tol=-1.0, max_iters=300))):
        gpu = PathDriver(L=L, device="cuda", **kw).run(ds.X, ds.y, **grid)
        cpu = PathDriver(L=L, device="cpu", **kw).run(ds.X, ds.y, **grid)
        rel = np.abs(gpu.objectives - cpu.objectives) / np.abs(cpu.objectives)
        out[label] = {"max_rel_obj": float(rel.max()), "kept_card": gpu.kept.tolist(),
                      "kept_cpu": cpu.kept.tolist(),
                      "iters_card": gpu.solver_iters.tolist(),
                      "iters_cpu": cpu.solver_iters.tolist()}
    emit(out)
    rel = out["fixed_iters"]["max_rel_obj"]
    require(rel <= 1e-6, f"card vs CPU path at 300 iterations per step: rel {rel:.3e}")


def missed_features(full, k, live) -> tuple:
    """``(support size, features nonzero in the unscreened step k that the
    mask ``live`` dropped)``."""
    w = np.abs(full.weights[k])
    support = w > 1e-6 * w.max() if w.max() > 0 else np.zeros_like(w, bool)
    return int(support.sum()), int(np.sum(support & ~live))


def phase_safety(svm_path, res, X, y):
    """Unscreened path on the first lambdas: every feature it makes nonzero
    is kept by the screened path at that step. The objective difference is
    reported, not checked: the two solves stop on fp32 plateaus of their
    own (see :func:`phase_small_vs_plain`). Returns the unscreened path."""
    lams = res.lambdas[:SAFETY_STEPS]
    t0 = time.perf_counter()
    full = svm_path(X, y, lambdas=lams, screening=False, device="cuda")
    secs = time.perf_counter() - t0
    masks = res.extras["keep_masks"]
    out = []
    for k in range(1, len(lams)):
        support, missed = missed_features(full, k, masks[k])
        rel = abs(full.objectives[k] - res.objectives[k]) / abs(full.objectives[k])
        out.append({"step": k, "support": support, "kept": int(res.kept[k]),
                    "missed": missed, "rel_obj": float(rel)})
        require(missed == 0, f"step {k}: {missed} active features were screened out")
    emit({"phase": "safety", "shape": [int(X.shape[0]), int(X.shape[1])],
          "steps": out, "unscreened_wall_s": secs,
          "unscreened_iters": full.solver_iters.tolist()})
    return full


def screened_slack_f64(res, X, y) -> tuple:
    """``(max rel objective error, worst screened-sample xi per step)``
    against a float64 recomputation from the returned ``(w, b)`` over all n
    samples; fails when a screened sample has ``xi > 1e-6``."""
    Xd, yd = X.double(), y.double()
    rel, xi_screened = [], []
    masks = res.extras["sample_masks"]
    for k in range(len(res.lambdas)):
        w = torch.from_numpy(res.weights[k]).cuda()
        xi = torch.clamp_min(1.0 - yd * (Xd.t() @ w + res.biases[k]), 0.0)
        obj = float(0.5 * (xi * xi).sum() + res.lambdas[k] * w.abs().sum())
        rel.append(abs(obj - res.objectives[k]) / abs(obj))
        screened = torch.from_numpy(~masks.get(k, np.ones(X.shape[1], bool))).cuda()
        worst = float(xi[screened].max()) if bool(screened.any()) else 0.0
        xi_screened.append(worst)
        require(worst <= 1e-6, f"step {k}: a screened sample has xi {worst:.3e} > 1e-6")
    del Xd
    require(max(rel) <= 1e-4, f"objective vs float64 recomputation: rel {max(rel):.3e}")
    return max(rel), xi_screened


def phase_composite_path(svm_path, ops, X, y) -> tuple:
    """The verified sample-screening path at full width: feature rule, then
    sample rule, gather on both axes, verification on the card.

    Checked: every kernel of the path launched, the sample-surplus kernel
    once on every screened step, no guard trip or refused screen,
    objectives within rel 1e-4 of a float64 recomputation over all n
    samples, and at every step every screened sample has ``xi <= 1e-6`` at
    the accepted ``(w, b)`` in float64 (the certificate that makes the rule
    exact)."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = svm_path(X, y, rules="composite", n_lambdas=N_LAMBDAS,
                   lam_min_ratio=COMPOSITE_RATIO, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = len(res.lambdas) - 1
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds",
                                          "sample_surplus")),
            f"a kernel of the composite path was never launched: {launches}")
    require(launches["sample_surplus"] == steps,
            f"sample_surplus launched {launches['sample_surplus']} times, "
            f"not once on each of the {steps} screened steps")
    variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad", "sample_surplus"),
                            "composite path")
    require(not np.any(res.extras["health"]), f"guard trips {res.extras['health']}")
    require(bool(np.all(np.isfinite(res.objectives))), "non-finite objective")
    rel, xi_screened = screened_slack_f64(res, X, y)
    solve_s = res.extras["solve_times"]
    emit({"phase": "composite_path", "shape": [int(X.shape[0]), int(X.shape[1])],
          "lam_min_ratio": COMPOSITE_RATIO, "lambdas": res.lambdas.tolist(),
          "kept": res.kept.tolist(), "kept_samples": res.kept_samples.tolist(),
          "verify_rounds": res.verify_rounds.tolist(),
          "iters": res.solver_iters.tolist(), "objectives": res.objectives.tolist(),
          "max_rel_obj_f64": rel, "max_xi_screened_f64": xi_screened,
          "wall_s": res.wall_times.tolist(), "screen_s": res.screen_times.tolist(),
          "solve_s": solve_s.tolist(), "path_wall_s": total, "launches": launches,
          "variants": variants})
    return res, launches


def phase_composite_small_vs_plain(PathDriver, lipschitz_estimate, make) -> None:
    """The composite path on the 2000 x 400 bench instance (seed 11, 8
    lambdas, lam_min_ratio 0.02) on the card and on the CPU, same L, in both
    reductions.

    Checked: at exactly 2000 FISTA iterations per step (``tol=-1``) the
    per-step objectives agree to rel 1e-6, and the card's path screens
    samples at some step. Why 2000 and not the 300 of
    :func:`phase_small_vs_plain`: on this deeper grid 300 iterations stop
    short of the fp32 floor at the last step (the unscreened path sits
    2.8e-6 above its 3000-iteration optimum there), so two runs that differ
    only in rounding (L x (1 +- 3e-7)) spread by up to 2e-6 on a CPU; at
    2000 iterations they spread by at most 3.2e-7 there. The 300-iteration
    spread is reported, not checked. Masks are reported, not checked."""
    ds = make(m=2000, n=400, seed=11)
    L = float(lipschitz_estimate(torch.from_numpy(ds.X)))
    grid = dict(n_lambdas=N_LAMBDAS, lam_min_ratio=COMPOSITE_RATIO)
    out = {"phase": "composite_bench_card_vs_cpu", "shape": [2000, 400],
           "tol_fixed_iters": 1e-6, "checked_iters": 2000}
    for reduce in ("gather", "mask"):
        for iters in (2000, 300):
            kw = dict(rules="composite", reduce=reduce, L=L, tol=-1.0,
                      max_iters=iters)
            gpu = PathDriver(device="cuda", **kw).run(ds.X, ds.y, **grid)
            cpu = PathDriver(device="cpu", **kw).run(ds.X, ds.y, **grid)
            rel = np.abs(gpu.objectives - cpu.objectives) / np.abs(cpu.objectives)
            out[f"{reduce}_iters{iters}"] = {
                "max_rel_obj": float(rel.max()),
                "kept_samples_card": gpu.kept_samples.tolist(),
                "kept_samples_cpu": cpu.kept_samples.tolist(),
                "verify_rounds_card": gpu.verify_rounds.tolist(),
                "verify_rounds_cpu": cpu.verify_rounds.tolist(),
                "kept_card": gpu.kept.tolist(), "kept_cpu": cpu.kept.tolist()}
            if iters == 2000:
                require(float(rel.max()) <= 1e-6,
                        f"composite {reduce}: card vs CPU at 2000 iterations "
                        f"per step: rel {float(rel.max()):.3e}")
                require(bool(np.any(gpu.kept_samples[1:] < 400)),
                        f"composite {reduce}: no sample screened on the card")
    emit(out)


def dynamic_summary(res) -> dict:
    """Per-step telemetry of a dynamic path: each step's kept counts after
    every refresh (and its live-sample counts), and the refresh count."""
    tele = res.extras["dynamic"]
    return {"kept_per_segment": {k: d["kept_per_segment"] for k, d in tele.items()},
            "kept_samples_per_segment": {k: d["kept_samples_per_segment"]
                                         for k, d in tele.items()
                                         if "kept_samples_per_segment" in d},
            "gap_last": {k: d["gap_per_segment"][-1] for k, d in tele.items()
                         if d["gap_per_segment"]},
            "refreshes": int(sum(d["segments"] for d in tele.values()))}


def phase_dynamic_feature_path(svm_path, ops, X, y, res_seq, full) -> dict:
    """The feature-rule path of :func:`phase_path` with dynamic screening
    (gather mode, a refresh every SCREEN_EVERY iterations).

    Checked: every kernel of the path launched (the dynamic variant once a
    refresh), the bulk variants only, no guard trip or refused refresh;
    objectives within rel 1e-4 of a float64 recomputation; no feature that
    the unscreened path (``full``, :func:`phase_safety`) makes nonzero was
    dropped, between the steps or inside a solve; and objectives within rel
    1e-5 of the sequential path ``res_seq``, the fp32 stop rule's stall
    scale (a failure there is a finding, not a tolerance to widen)."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = svm_path(X, y, n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO,
                   dynamic=True, screen_every=SCREEN_EVERY, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = ops.launch_counts()
    summary = dynamic_summary(res)
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds",
                                          "screen_bounds_dynamic")),
            f"a kernel of the dynamic feature path was never launched: {launches}")
    require(launches["screen_bounds_dynamic"] == summary["refreshes"],
            f"screen_bounds_dynamic launched {launches['screen_bounds_dynamic']} "
            f"times for {summary['refreshes']} refreshes")
    variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad"),
                            "dynamic feature path")
    require(not np.any(res.extras["health"]), f"health {res.extras['health']}")
    require(bool(np.all(np.isfinite(res.objectives))), "non-finite objective")
    phase_objective_check(res, X, y, "dynamic_feature_objective_f64")
    require(np.array_equal(res.lambdas[:len(full.lambdas)], full.lambdas),
            "the dynamic path's grid differs from the unscreened one's")
    live = res.extras["dynamic_keep_masks"]
    safety = []
    for k in range(1, len(full.lambdas)):
        support, missed = missed_features(full, k, live[k])
        safety.append({"step": k, "support": support, "live": int(live[k].sum()),
                       "missed": missed})
        require(missed == 0, f"dynamic step {k}: {missed} active features were dropped")
    rel = np.abs(res.objectives - res_seq.objectives) / np.abs(res_seq.objectives)
    require(float(rel.max()) <= 1e-5,
            f"dynamic vs sequential feature path: rel {float(rel.max()):.3e} > 1e-5")
    emit({"phase": "dynamic_feature_path", "shape": [int(X.shape[0]), int(X.shape[1])],
          "screen_every": SCREEN_EVERY, "kept": res.kept.tolist(),
          "active": res.active.tolist(), "iters": res.solver_iters.tolist(),
          "objectives": res.objectives.tolist(),
          "max_rel_obj_vs_sequential": float(rel.max()), "safety": safety, **summary,
          "wall_s": res.wall_times.tolist(),
          "solve_s": res.extras["solve_times"].tolist(), "path_wall_s": total,
          "sequential_iters": res_seq.solver_iters.tolist(),
          "launches": launches, "variants": variants})
    return launches


def phase_dynamic_composite_path(svm_path, ops, X, y) -> dict:
    """The composite path in mask mode with dynamic screening and the
    in-solver sample re-screen, then the same path sequential (walls side
    by side).

    Checked on the dynamic run: every kernel launched (sample surplus once a
    screened step, the dynamic variant once a refresh), the bulk variants
    only, no guard trip or refused refresh, objectives within rel 1e-4 of
    float64, and at every step every screened sample (the rule's and the
    solver's drops, verified) has ``xi <= 1e-6`` at the accepted solution in
    float64."""
    kw = dict(rules="composite", reduce="mask", n_lambdas=N_LAMBDAS,
              lam_min_ratio=COMPOSITE_RATIO, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = svm_path(X, y, dynamic=True, screen_every=SCREEN_EVERY, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = ops.launch_counts()
    summary = dynamic_summary(res)
    steps = len(res.lambdas) - 1
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds",
                                          "screen_bounds_dynamic", "sample_surplus")),
            f"a kernel of the dynamic composite path was never launched: {launches}")
    require(launches["sample_surplus"] == steps,
            f"sample_surplus launched {launches['sample_surplus']} times, not {steps}")
    # the telemetry holds the accepted solve's refreshes; a verification
    # re-solve refreshes too
    require(launches["screen_bounds_dynamic"] >= summary["refreshes"] > 0,
            f"screen_bounds_dynamic launched {launches['screen_bounds_dynamic']} "
            f"times for {summary['refreshes']} refreshes")
    variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad", "sample_surplus"),
                            "dynamic composite path")
    require(not np.any(res.extras["health"]), f"health {res.extras['health']}")
    require(bool(np.all(np.isfinite(res.objectives))), "non-finite objective")
    # the in-solver sample re-screen ran in every step's first solve (a
    # verification re-solve runs without it)
    first = [k for k in range(1, steps + 1) if res.verify_rounds[k] == 0]
    require(all(k in summary["kept_samples_per_segment"] for k in first),
            "the in-solver sample re-screen did not run")
    rel, xi_screened = screened_slack_f64(res, X, y)
    t0 = time.perf_counter()
    seq = svm_path(X, y, **kw)
    torch.cuda.synchronize()
    seq_total = time.perf_counter() - t0
    rel_seq = np.abs(res.objectives - seq.objectives) / np.abs(seq.objectives)
    emit({"phase": "dynamic_composite_path", "shape": [int(X.shape[0]), int(X.shape[1])],
          "reduce": "mask", "screen_every": SCREEN_EVERY, "lambdas": res.lambdas.tolist(),
          "kept": res.kept.tolist(), "kept_samples": res.kept_samples.tolist(),
          "verify_rounds": res.verify_rounds.tolist(),
          "iters": res.solver_iters.tolist(), "objectives": res.objectives.tolist(),
          "max_rel_obj_f64": rel, "max_xi_screened_f64": xi_screened, **summary,
          "wall_s": res.wall_times.tolist(), "path_wall_s": total,
          "sequential": {"path_wall_s": seq_total, "iters": seq.solver_iters.tolist(),
                         "kept_samples": seq.kept_samples.tolist(),
                         "verify_rounds": seq.verify_rounds.tolist(),
                         "max_rel_obj_dynamic_vs_sequential": float(rel_seq.max())},
          "launches": launches, "variants": variants})
    return launches


def phase_dynamic_small_vs_plain(PathDriver, lipschitz_estimate, make) -> None:
    """The bench instance (2000 x 400, seed 11) with dynamic screening on
    the card and on the CPU, same L, at fixed iterations (``tol=-1``): the
    feature rule in gather mode (10 lambdas, 0.05, 300 iterations a step, as
    :func:`phase_small_vs_plain`) and the composite rule in mask mode with
    the in-solver sample re-screen (8 lambdas, 0.02, 2000 iterations, as
    :func:`phase_composite_small_vs_plain`). Checked: per-step objectives
    agree to rel 1e-6 (on the CPU, runs whose L differs by 3e-7 spread by
    1.5e-7 and 1.9e-7). Both sides' kept counts per segment are printed,
    not checked: a bound within rounding of tau may fall either way."""
    ds = make(m=2000, n=400, seed=11)
    L = float(lipschitz_estimate(torch.from_numpy(ds.X)))
    out = {"phase": "dynamic_bench_card_vs_cpu", "shape": [2000, 400], "tol": 1e-6}
    for label, rules, reduce, grid, iters in (
            ("feature_gather", "feature_vi", "gather",
             dict(n_lambdas=10, lam_min_ratio=0.05), 300),
            ("composite_mask", "composite", "mask",
             dict(n_lambdas=N_LAMBDAS, lam_min_ratio=COMPOSITE_RATIO), 2000)):
        kw = dict(rules=rules, reduce=reduce, L=L, tol=-1.0, max_iters=iters,
                  dynamic=True, screen_every=SCREEN_EVERY)
        gpu = PathDriver(device="cuda", **kw).run(ds.X, ds.y, **grid)
        cpu = PathDriver(device="cpu", **kw).run(ds.X, ds.y, **grid)
        rel = float((np.abs(gpu.objectives - cpu.objectives) / np.abs(cpu.objectives)).max())
        out[label] = {"iters": iters, "max_rel_obj": rel,
                      "kept_per_segment_card": dynamic_summary(gpu)["kept_per_segment"],
                      "kept_per_segment_cpu": dynamic_summary(cpu)["kept_per_segment"],
                      "kept_samples_card": gpu.kept_samples.tolist(),
                      "kept_samples_cpu": cpu.kept_samples.tolist()}
        require(rel <= 1e-6, f"dynamic {label}: card vs CPU at {iters} iterations "
                             f"per step: rel {rel:.3e}")
    emit(out)


def phase_rule_path(svm_path, ops, X, y, rules, res_vi, full) -> dict:
    """A feature rule of this slice (``rules``: ``"edpp"``, or an
    ``AutoRule`` instance) on the feature path's grid at full width.

    Checked: the path launched the margin and gradient kernels (bulk
    variants only) and the feature screen's EDPP mode once a screened step
    (``auto`` adds one VI-mode launch a step it sweeps the old anchor); no
    guard trip or refused screen; objectives within rel 1e-4 of float64; no
    feature that the unscreened path (``full``, :func:`phase_safety`) makes
    nonzero was screened; and the kept counts never above the VI path's
    (``res_vi``) at the same step. Printed beside them: the VI path's kept
    counts and, for ``auto``, its telemetry (probes, extra screened, sweep
    seconds, the cost model)."""
    label = rules if isinstance(rules, str) else rules.name
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = svm_path(X, y, rules=rules, n_lambdas=N_LAMBDAS,
                   lam_min_ratio=LAM_MIN_RATIO, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = len(res.lambdas) - 1
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds_edpp")),
            f"a kernel of the {label} path was never launched: {launches}")
    require(launches["screen_bounds_edpp"] == steps,
            f"{label}: screen_bounds_edpp launched {launches['screen_bounds_edpp']} "
            f"times, not once on each of the {steps} screened steps")
    variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad"), f"{label} path")
    require(not np.any(res.extras["health"]), f"guard trips {res.extras['health']}")
    require(bool(np.all(np.isfinite(res.objectives))), "non-finite objective")
    phase_objective_check(res, X, y, f"{label}_objective_f64")
    require(np.array_equal(res.lambdas, res_vi.lambdas), f"{label}: grid differs")
    masks = res.extras["keep_masks"]
    safety = []
    for k in range(1, len(full.lambdas)):
        support, missed = missed_features(full, k, masks[k])
        safety.append({"step": k, "support": support, "kept": int(res.kept[k]),
                       "missed": missed})
        require(missed == 0, f"{label} step {k}: {missed} active features were screened out")
    out = {"phase": f"{label}_path", "shape": [int(X.shape[0]), int(X.shape[1])],
           "lambdas": res.lambdas.tolist(), "kept": res.kept.tolist(),
           "kept_feature_vi": res_vi.kept.tolist(), "active": res.active.tolist(),
           "iters": res.solver_iters.tolist(), "objectives": res.objectives.tolist(),
           "max_rel_obj_vs_feature_vi": float(np.max(
               np.abs(res.objectives - res_vi.objectives) / np.abs(res_vi.objectives))),
           "safety": safety, "wall_s": res.wall_times.tolist(),
           "screen_s": res.screen_times.tolist(),
           "solve_s": res.extras["solve_times"].tolist(), "path_wall_s": total,
           "launches": launches, "variants": variants}
    if not isinstance(rules, str):  # auto: its telemetry
        swept = [t for t in rules.telemetry if t["extra_swept"]]
        require(launches["screen_bounds"] == len(swept),
                f"auto: {launches['screen_bounds']} VI-mode launches for "
                f"{len(swept)} old-anchor sweeps")
        require(rules._solve_per_feat is not None and rules._solve_per_feat > 0,
                "auto: PathDriver did not feed the cost model")
        out["telemetry"] = rules.telemetry
        out["solve_s_per_kept_feature_ema"] = rules._solve_per_feat
    emit(out)
    return launches


def phase_sifs_path(svm_path, ops, X, y, verify_rule) -> tuple:
    """``rules="sifs"`` (EDPP features, verified samples) with gather on
    both axes, on the composite path's grid at full width.

    Checked: every kernel of the path launched (the EDPP mode and the
    sample surplus once a screened step), bulk variants only, no guard
    trip, objectives within rel 1e-4 of float64, and every screened sample
    at ``xi <= 1e-6`` in float64 at every step. Then one verification round
    at the last step's accepted ``(w, b)`` over its screened samples
    (``verify_rule``, the float64 test over the support of w), timed."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = svm_path(X, y, rules="sifs", reduce="gather", n_lambdas=N_LAMBDAS,
                   lam_min_ratio=COMPOSITE_RATIO, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = len(res.lambdas) - 1
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad",
                                          "screen_bounds_edpp", "sample_surplus")),
            f"a kernel of the sifs path was never launched: {launches}")
    require(launches["screen_bounds_edpp"] == steps == launches["sample_surplus"],
            f"sifs: EDPP {launches['screen_bounds_edpp']} and sample surplus "
            f"{launches['sample_surplus']} launches for {steps} screened steps")
    variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad", "sample_surplus"),
                            "sifs path")
    require(not np.any(res.extras["health"]), f"guard trips {res.extras['health']}")
    require(bool(np.all(np.isfinite(res.objectives))), "non-finite objective")
    rel, xi_screened = screened_slack_f64(res, X, y)
    require(bool(np.any(res.kept_samples[1:] < X.shape[1])), "sifs: no sample screened")
    # one verification round at full width, as PathDriver runs it
    k = len(res.lambdas) - 1
    scr = torch.from_numpy(np.nonzero(~res.extras["sample_masks"][k])[0]).cuda()
    w = torch.from_numpy(res.weights[k]).float().cuda()
    b = torch.tensor(float(res.biases[k]), device="cuda")
    viol = verify_rule.verify(X, y, w, b, scr)
    require(viol.numel() == 0, f"sifs: {viol.numel()} violators at the accepted step")
    reps = 20
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        verify_rule.verify(X, y, w, b, scr).cpu()
    verify_ms = (time.perf_counter() - t1) / reps * 1e3
    emit({"phase": "sifs_path", "shape": [int(X.shape[0]), int(X.shape[1])],
          "reduce": "gather", "lam_min_ratio": COMPOSITE_RATIO,
          "lambdas": res.lambdas.tolist(), "kept": res.kept.tolist(),
          "kept_samples": res.kept_samples.tolist(),
          "verify_rounds": res.verify_rounds.tolist(), "active": res.active.tolist(),
          "iters": res.solver_iters.tolist(), "objectives": res.objectives.tolist(),
          "max_rel_obj_f64": rel, "max_xi_screened_f64": xi_screened,
          "wall_s": res.wall_times.tolist(), "screen_s": res.screen_times.tolist(),
          "solve_s": res.extras["solve_times"].tolist(), "path_wall_s": total,
          "verify_round_ms": verify_ms, "verify_screened": int(scr.numel()),
          "verify_support": int((w != 0).sum()), "launches": launches,
          "variants": variants})
    return res, launches


def phase_rules_small_vs_plain(PathDriver, lipschitz_estimate, make) -> None:
    """The bench instance (2000 x 400, seed 11) on the card and on the CPU,
    same L, at fixed iterations: ``edpp`` on the feature grid (10 lambdas,
    0.05, 300 iterations a step, as :func:`phase_small_vs_plain`) and
    ``sifs`` in gather mode on the deep grid (8 lambdas, 0.02, 2000
    iterations, as :func:`phase_composite_small_vs_plain`). Checked:
    per-step objectives agree to rel 1e-6, and the card's sifs path screens
    samples."""
    ds = make(m=2000, n=400, seed=11)
    L = float(lipschitz_estimate(torch.from_numpy(ds.X)))
    out = {"phase": "rules_bench_card_vs_cpu", "shape": [2000, 400], "tol": 1e-6}
    for rules, grid, iters in (("edpp", dict(n_lambdas=10, lam_min_ratio=0.05), 300),
                               ("sifs", dict(n_lambdas=N_LAMBDAS,
                                             lam_min_ratio=COMPOSITE_RATIO), 2000)):
        kw = dict(rules=rules, reduce="gather", L=L, tol=-1.0, max_iters=iters)
        gpu = PathDriver(device="cuda", **kw).run(ds.X, ds.y, **grid)
        cpu = PathDriver(device="cpu", **kw).run(ds.X, ds.y, **grid)
        rel = float((np.abs(gpu.objectives - cpu.objectives) / np.abs(cpu.objectives)).max())
        out[rules] = {"iters": iters, "max_rel_obj": rel, "kept_card": gpu.kept.tolist(),
                      "kept_cpu": cpu.kept.tolist(),
                      "kept_samples_card": gpu.kept_samples.tolist(),
                      "kept_samples_cpu": cpu.kept_samples.tolist()}
        require(rel <= 1e-6, f"{rules}: card vs CPU at {iters} iterations per step: "
                             f"rel {rel:.3e}")
    require(bool(np.any(np.array(out["sifs"]["kept_samples_card"][1:]) < 400)),
            "sifs: no sample screened on the card")
    emit(out)


def phase_path_walls(svm_path, X, y) -> None:
    """Dynamic against sequential path walls at full width, in turns
    (sequential, dynamic, dynamic, sequential) after every path has run
    once: the feature path (gather) and the composite path in mask mode.
    Reported, not checked; the total FISTA iterations beside each wall
    tell the refreshes' cost from the iterations that momentum restarts
    add."""
    def run(**kw):
        t0 = time.perf_counter()
        res = svm_path(X, y, device="cuda", **kw)
        torch.cuda.synchronize()
        return [time.perf_counter() - t0, int(res.solver_iters.sum())]

    dyn = dict(dynamic=True, screen_every=SCREEN_EVERY)
    out = {"phase": "path_walls", "order": "sequential, dynamic, dynamic, sequential",
           "entry": "[wall_s, total FISTA iterations]"}
    for label, kw in (("feature_gather", dict(n_lambdas=N_LAMBDAS,
                                              lam_min_ratio=LAM_MIN_RATIO)),
                      ("composite_mask", dict(rules="composite", reduce="mask",
                                              n_lambdas=N_LAMBDAS,
                                              lam_min_ratio=COMPOSITE_RATIO))):
        out[label] = [run(**kw), run(**kw, **dyn), run(**kw, **dyn), run(**kw)]
    emit(out)


def scan_summary(res, wall, launches, skipped) -> dict:
    """What a scan-engine path printed: caps, kept, iterations, walls,
    per-iteration solve walls, host fetches, graph replays, launches."""
    it = res.solver_iters
    solve_s = res.extras["solve_seconds"]
    return {"lambdas": res.lambdas.tolist(), "kept": res.kept.tolist(),
            "caps": res.extras["caps"].tolist(), "active": res.active.tolist(),
            "iters": it.tolist(), "objectives": res.objectives.tolist(),
            "path_wall_s": wall, "solve_s": solve_s.tolist(),
            "solve_s_per_iter": [float(solve_s[k] / it[k]) if it[k] else None
                                 for k in range(len(it))],
            "path_s_per_iter": wall / max(int(it.sum()), 1),
            "host_fetches": res.extras["host_fetches"],
            "host_fetches_total": int(sum(res.extras["host_fetches"].values())),
            "graphs": res.extras["graphs"], "launches": launches, "skipped": skipped}


def require_fetch_bound(res, chunk_iters, where) -> None:
    """At most one fetch a step plus one a chunk of every solve (and one to
    set up, one for the result, one a dynamic segment): never one an
    iteration."""
    f = res.extras["host_fetches"]
    bound = (len(res.lambdas) + 2 + f["segment"]
             + sum(int(k) // chunk_iters + 1 for k in res.solver_iters))
    require(f["host_loop"] == 0 and sum(f.values()) <= bound,
            f"{where}: host fetches {f} above the bound {bound}")


def phase_scan_path(svm_path, ops, chunk_iters, X, y, res_host, full) -> tuple:
    """The feature path on the scan engine, ``reduce="compact"``, at full
    width. A first run captures the chunk graphs; then host and scan paths
    in turns (host, scan, scan, host), the first scan run the counted one;
    then both engines in turns at 50 iterations a step (the same work),
    their full-width steps' solve seconds per iteration reported.

    Checked on it: the margin, gradient and feature-screen kernels launched
    (bulk variants only), the predicated sweeps switched off at least once,
    no capture (every graph cached), graph replays, no guard trip,
    objectives within rel 1e-4 of float64 and rel 1e-5 of the host
    engine's (``res_host``; the fp32 stop rule's stall scale), no feature
    the unscreened path (``full``) makes nonzero screened, and the host
    fetches within one a step plus one a chunk."""
    kw = dict(n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO, device="cuda")

    def run(engine, counted=False, **extra):
        if counted:
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = (svm_path(X, y, engine="scan", reduce="compact", **kw, **extra)
             if engine == "scan" else svm_path(X, y, **kw, **extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if counted:
            return r, wall, ops.launch_counts(), ops.skipped_counts()
        return r, wall

    first, first_wall = run("scan")
    walls = [run("host")[1]]
    res, wall, launches, skipped = run("scan", counted=True)
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds")),
            f"a kernel of the scan path was never launched: {launches}")
    require(skipped["margin_obj"] > 0 and skipped["hinge_grad"] > 0,
            f"scan path: no predicated sweep was switched off: {skipped}")
    variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad"), "scan path")
    walls += [wall, run("scan")[1], run("host")[1]]
    # the same work on both engines: 50 iterations a step, in turns; the
    # full-width steps' solve seconds per iteration
    m = X.shape[0]
    fixed_turns = []
    for engine in ("host", "scan", "scan", "host"):
        r, w = run(engine, tol=-1.0, max_iters=50)
        solve_s = r.extras["solve_times" if engine == "host" else "solve_seconds"]
        fixed_turns.append({"engine": engine, "path_wall_s": w, "full_width_s_per_iter": [
            float(solve_s[k] / r.solver_iters[k]) for k in range(len(r.lambdas))
            if r.kept[k] == m and r.solver_iters[k]]})
    g = res.extras["graphs"]
    require(g["captures"] == 0 and g["replays"] > 0, f"scan path graphs {g}")
    require(not np.any(res.extras["health"]), f"health {res.extras['health']}")
    require(bool(np.all(np.isfinite(res.objectives))), "non-finite objective")
    phase_objective_check(res, X, y, "scan_objective_f64")
    require(np.array_equal(res.lambdas, res_host.lambdas), "scan: grid differs")
    rel_host = float(np.max(np.abs(res.objectives - res_host.objectives)
                            / np.abs(res_host.objectives)))
    require_fetch_bound(res, chunk_iters, "scan path")
    safety = []
    for k in range(1, len(full.lambdas)):
        support, missed = missed_features(full, k, res.extras["keep_masks"][k])
        safety.append({"step": k, "support": support, "kept": int(res.kept[k]),
                       "missed": missed})
        require(missed == 0, f"scan step {k}: {missed} active features were screened out")
    emit({"phase": "scan_path", "shape": [int(X.shape[0]), int(X.shape[1])],
          "reduce": "compact", "chunk_iters": chunk_iters,
          **scan_summary(res, wall, launches, skipped),
          "first_run": {"path_wall_s": first_wall, "graphs": first.extras["graphs"]},
          "max_rel_obj_vs_host": rel_host, "host_iters": res_host.solver_iters.tolist(),
          "walls_in_turns": {"order": "host, scan, scan, host", "s": walls},
          "fixed_50_iters_in_turns": fixed_turns,
          "safety": safety, "variants": variants})
    require(rel_host <= 1e-5, f"scan vs host engine objectives: rel {rel_host:.3e}")
    return res, dict(launches, **{f"skipped_{k}": v for k, v in skipped.items()})


def phase_engine_memory(clear_engine_cache, engine_cache_info, after) -> None:
    """The device memory that the engines' warm cache holds after the
    ``after`` phase (captured graphs with their private pools, compact
    buffers), allocated and reserved, before and after
    ``clear_engine_cache`` (then ``torch.cuda.empty_cache``). Checked: the
    clear frees at least the buffers' bytes and leaves no graph cached."""
    gib = 2.0 ** 30
    torch.cuda.synchronize()
    before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    dropped = clear_engine_cache()
    torch.cuda.empty_cache()
    after_clear = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    emit({"phase": "engine_memory", "after": after, "dropped": dropped,
          "allocated_gib": [before[0] / gib, after_clear[0] / gib],
          "reserved_gib": [before[1] / gib, after_clear[1] / gib]})
    require(before[0] - after_clear[0] >= dropped["buffer_bytes"]
            and not engine_cache_info(),
            f"engine cache clear after {after}: allocated {before[0]} -> "
            f"{after_clear[0]}, buffers {dropped['buffer_bytes']} bytes")


def phase_scan_small_vs_plain(svm_path_scan, lipschitz_estimate, make) -> None:
    """The bench instance (2000 x 400, seed 11, 10 lambdas, ratio 0.05) on
    the scan engine, card against CPU, same L, at 300 FISTA iterations a
    step (``tol=-1``): mask and compact, ``edpp`` and ``dvi``. Checked:
    objectives rel 1e-6 (as :func:`phase_small_vs_plain`). Kept counts and
    capacities printed."""
    ds = make(m=2000, n=400, seed=11)
    L = float(lipschitz_estimate(torch.from_numpy(ds.X)))
    out = {"phase": "scan_bench_card_vs_cpu", "shape": [2000, 400], "tol": 1e-6,
           "iters": 300}
    for reduce in ("mask", "compact"):
        for rules in ("edpp", "dvi"):
            kw = dict(rules=rules, reduce=reduce, L=L, tol=-1.0, max_iters=300,
                      n_lambdas=10, lam_min_ratio=0.05)
            gpu = svm_path_scan(ds.X, ds.y, device="cuda", **kw)
            cpu = svm_path_scan(ds.X, ds.y, device="cpu", **kw)
            rel = float((np.abs(gpu.objectives - cpu.objectives)
                         / np.abs(cpu.objectives)).max())
            out[f"{reduce}_{rules}"] = {
                "max_rel_obj": rel, "kept_card": gpu.kept.tolist(),
                "kept_cpu": cpu.kept.tolist(), "caps_card": gpu.extras["caps"].tolist(),
                "caps_cpu": cpu.extras["caps"].tolist(),
                "wall_card_s": gpu.extras["total_seconds"],
                "wall_cpu_s": cpu.extras["total_seconds"]}
    emit(out)
    for key, v in out.items():
        if isinstance(v, dict):
            require(v["max_rel_obj"] <= 1e-6,
                    f"scan {key}: card vs CPU rel {v['max_rel_obj']:.3e}")


def phase_batched_path(svm_path_batched, svm_path_scan, compact_caps_batched,
                       lambda_max, ops, chunk_iters, second, X, y, lam_max) -> dict:
    """The batched engine, compact, at BATCH_FIXED_ITERS FISTA iterations a
    step: 4 grids (ratios BATCH_RATIOS, 8 lambdas) on the full-width X, then
    2 problems (seeds 0 and 1, 50,000 x 10,000 each: X 4 GB; ``second``,
    a future, makes the seed-1 data on the host). Checked on
    each: the kernels launched (bulk variants), every element within rel
    1e-6 of the single-path engine on its grid, the shared capacity the
    batch-max kept count selects, and the host fetches within one a step
    plus one a chunk. Returns the grids run's launch counts."""
    m, n = X.shape
    fixed = dict(tol=-1.0, max_iters=BATCH_FIXED_ITERS, reduce="compact", device="cuda")
    out = {"phase": "batched_path", "shape": [m, n], "iters": BATCH_FIXED_ITERS, "tol": 1e-6}
    failures = []

    def run(label, Xs, ys, grids, single_args):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        batched = svm_path_batched(Xs, ys, lambdas=grids, **fixed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, skipped = ops.launch_counts(), ops.skipped_counts()
        variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad"), label)
        require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds")),
                f"{label}: a kernel was never launched: {launches}")
        singles = [svm_path_scan(*a, lambdas=g, **fixed) for a, g in zip(single_args, grids)]
        kept = np.stack([b.kept for b in batched])
        caps = [compact_caps_batched(m, kept[:, k]) for k in range(kept.shape[1])]
        rels = []
        for b, sgl in zip(batched, singles):
            rels.append(float(np.max(np.abs(b.objectives - sgl.objectives)
                                     / np.abs(sgl.objectives))))
            if not np.array_equal(b.extras["caps"], caps):
                failures.append(f"{label}: caps {b.extras['caps'].tolist()} not {caps}")
            if np.any(b.extras["health"]):
                failures.append(f"{label}: health {b.extras['health'].tolist()}")
        if max(rels) > 1e-6:
            failures.append(f"{label}: element vs single path rel {max(rels):.3e}")
        f = batched[0].extras["host_fetches"]
        bound = (kept.shape[1] + 2 + sum(int(k) // chunk_iters + 1
                                         for b in batched for k in b.solver_iters))
        if f["host_loop"] or sum(f.values()) > bound:
            failures.append(f"{label}: host fetches {f} above {bound}")
        out[label] = {"batch": len(batched), "kept": kept.tolist(), "caps": caps,
                      "iters": [b.solver_iters.tolist() for b in batched],
                      "max_rel_obj_vs_single": rels, "path_wall_s": wall,
                      "single_walls_s": [sgl.extras["total_seconds"] for sgl in singles],
                      "host_fetches": f, "graphs": batched[0].extras["graphs"],
                      "launches": launches, "skipped": skipped, "variants": variants}
        return dict(launches, **{f"skipped_{k}": v for k, v in skipped.items()})

    grids = np.stack([np.geomspace(lam_max, lam_max * r, N_LAMBDAS) for r in BATCH_RATIOS])
    grid_launches = run("grids", X, y, grids, [(X, y)] * len(grids))
    ds1 = second.result()
    Xb = torch.stack([X, torch.from_numpy(ds1.X).cuda()])
    yb = torch.stack([y, torch.from_numpy(ds1.y).cuda()])
    del ds1
    lmax1 = float(lambda_max(Xb[1], yb[1]))
    pgrids = np.stack([np.geomspace(lm, lm * LAM_MIN_RATIO, N_LAMBDAS)
                       for lm in (lam_max, lmax1)])
    run("problems", Xb, yb, pgrids, [(Xb[0], yb[0]), (Xb[1], yb[1])])
    del Xb, yb
    torch.cuda.empty_cache()
    emit(out)
    require(not failures, "; ".join(failures))
    return grid_launches


#: the path server's full-width tenants, cut from the bench X (rows, columns):
#: every one in the (65,536, 16,384) bucket, 4.29 GB a padded slot
SERVE_TENANTS = [(50_000, 10_000), (45_000, 9_000), (40_000, 10_000), (36_000, 8_500),
                 (50_000, 9_500), (33_000, 9_000)]
SERVE_SLOTS = 4
#: the second group: three tenants of ~20,000 x 4,000 with EDPP (``auto``
#: resolves to it), the weighted EDPP mode under the slots' sample masks
SERVE_EDPP_TENANTS = [(20_000, 4_000, "edpp"), (19_000, 3_900, "auto"),
                      (18_500, 4_000, "edpp")]
SERVE_SEED = 5
SERVE_LIVE = 9_000  # live samples of the weighted modes' timing mask


def _quiet(*a, **k) -> None:
    """A serve log that prints nothing (each phase prints its JSON line)."""


def serve_jobs(PathJob, X, y, tenants, seed, first_jid=0) -> list:
    """Jobs over views of the bench X: tenant ``(m, n[, rules])`` is its
    first m rows and n columns, with a ragged grid drawn as ``demo_jobs``
    draws them (T from 4 to 9, lam_min_ratio from 0.1 to 0.3)."""
    rng = np.random.default_rng(seed)
    jobs = []
    for i, t in enumerate(tenants):
        m, n = t[:2]
        jobs.append(PathJob(jid=first_jid + i, X=X[:m, :n], y=y[:n],
                            n_lambdas=int(rng.integers(4, 10)),
                            lam_min_ratio=float(rng.uniform(0.1, 0.3)),
                            rules=t[2] if len(t) > 2 else "feature_vi"))
    return jobs


def merge_counts(parts) -> tuple:
    """The launch, variant and skipped counts of several counted runs,
    summed: ``parts`` holds each run's ``(launches, variants, skipped)``."""
    launches, variants, skipped = {}, {}, {}
    for lc, vc, sk in parts:
        for k, v in lc.items():
            launches[k] = launches.get(k, 0) + v
        for k, v in sk.items():
            skipped[k] = skipped.get(k, 0) + v
        for k, per in vc.items():
            into = variants.setdefault(k, {})
            for var, c in per.items():
                into[var] = into.get(var, 0) + c
    return launches, variants, skipped


def serve_breakdown(PathServer, server_mod, lipschitz_estimate, jobs) -> dict:
    """Where a serve's wall goes: the tenants served again on a fresh
    server with the card synchronized around each part, the refill
    (``_insert``: the slot zeroed and filled, the anchor, the Lipschitz
    estimate on the padded slot), the batched step on the card
    (``_batched_path_step``: screens, solves, certificates) and the rest of
    the step on the host (the outputs fetched, the finiteness check, the
    streams). Beside them, one Lipschitz estimate's device time on the
    padded slot and on the true X it holds (zero padding leaves
    sigma_max as it is)."""
    srv = PathServer(slots=SERVE_SLOTS, reduce="compact", device="cuda")
    secs = {"refill_s": 0.0, "step_s": 0.0, "batched_step_s": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t0
            return out
        return run

    srv._insert = timed("refill_s", srv._insert)
    srv.step = timed("step_s", srv.step)
    batched = server_mod._batched_path_step
    server_mod._batched_path_step = timed("batched_step_s", batched)
    try:
        srv.serve(jobs, log=_quiet)
    finally:
        server_mod._batched_path_step = batched
        del srv._insert, srv.step  # the wrappers hold srv: no cycle outlives it
    m, n = jobs[0].X.shape
    out = {"wall_s": srv.last_serve["wall_s"], "inserts": len(jobs),
           "steps": srv.last_serve["steps"], **secs,
           "host_check_s": secs["step_s"] - secs["batched_step_s"],
           "lipschitz_ms_padded_slot": timed_ms(lambda: lipschitz_estimate(srv._X[0]), 2),
           "lipschitz_ms_true_x": timed_ms(
               lambda: lipschitz_estimate(srv._X[0][:m, :n]), 2),
           "true_shape_of_slot0": [m, n]}
    out["other_s"] = out["wall_s"] - secs["refill_s"] - secs["step_s"]
    del srv
    return out


def phase_serve(PathServer, PathJob, server_mod, svm_path, clear_engine_cache,
                lipschitz_estimate, path_scan, K, gen, ops, X, y) -> tuple:
    """The path server at full width: 6 tenants cut from the bench X through
    4 slots (one group of the (65,536, 16,384) bucket, ``feature_vi``,
    compact), then, on the same server, 3 EDPP tenants of ~20,000 x 4,000
    (the group's slots reallocated; the feature screen's weighted EDPP
    mode; the fourth slot stays empty and is not screened). The launch
    counts are set to 0 just before each serve and read just after it.
    After each serve, what its steps left on the card (a slot, the largest
    compact buffer) goes through each of its kernels against the plain
    version (:meth:`Kernels.serve_slot`), timed. Checked: the margin,
    gradient, weighted VI and weighted EDPP screen kernels launched (bulk
    variants), every job within rel 1e-5 of the port's own
    ``svm_path(engine="scan", reduce="compact")`` on its true X and grid, a
    padded row's weight exactly 0 and never kept, caps and kept counts at
    most the true m, no feature that the unscreened path of one tenant of
    each group makes nonzero screened, the program cache warm (one program
    a miss, more hits than misses, no graph re-captured). Prints jobs/s,
    latencies, occupancy, steps, graph captures and replays, peak device
    memory, the solve seconds an iteration of the padded mask-mode steps
    beside the unpadded scan path's, and where the first group's wall goes
    (:func:`serve_breakdown`). Returns the serve's launch counts and the
    kernels' checks and times at the serve's shapes, by group."""
    clear_engine_cache()
    torch.cuda.empty_cache()
    groups = [serve_jobs(PathJob, X, y, SERVE_TENANTS, SERVE_SEED),
              serve_jobs(PathJob, X, y, SERVE_EDPP_TENANTS, SERVE_SEED + 1, 10)]
    torch.cuda.synchronize()
    server = PathServer(slots=SERVE_SLOTS, reduce="compact", device="cuda")
    summaries, results, parts, at_shapes = [], [], [], {}
    peak = 0
    for label, jobs in zip(("full_width", "edpp"), groups):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        results.append(server.serve(jobs, log=_quiet))
        torch.cuda.synchronize()
        parts.append((ops.launch_counts(), ops.variant_counts(), ops.skipped_counts()))
        peak = max(peak, torch.cuda.max_memory_allocated())
        summaries.append(dict(server.last_serve))
        n_b = jobs[0].group_key()[1]
        bufs = [b for b in path_scan._COMPACT_BUFFERS.values()
                if b.is_cuda and b.shape[1] == n_b]
        at_shapes[label] = K.serve_slot(server, bufs, gen, f"serve {label}")
        del bufs
    launches, variants, skipped = merge_counts(parts)
    cache = server.cache_stats()
    require_bulk(ops, launches, ("margin_obj", "hinge_grad"), "serve", variants)
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad",
                                          "screen_bounds_dynamic",
                                          "screen_bounds_edpp_weighted")),
            f"serve: a kernel of the server was never launched: {launches}")
    require(cache["programs"] == cache["misses"] and cache["hits"] > cache["misses"]
            and cache["retraces"] == 0, f"serve: program cache {cache}")
    del server
    clear_engine_cache()
    torch.cuda.empty_cache()
    breakdown = serve_breakdown(PathServer, server_mod, lipschitz_estimate,
                                serve_jobs(PathJob, X, y, SERVE_TENANTS, SERVE_SEED))
    jobs_out, failures = [], []
    mask_rate = {"serve_s_per_iter": [], "scan_s_per_iter": []}
    for jobs, res in zip(groups, results):
        for job, r in zip(jobs, res):
            m, n = job.X.shape
            Xt = job.X.contiguous()
            seq = svm_path(Xt, job.y, lambdas=job.lambdas, engine="scan",
                           reduce="compact", rules=job.rules, device="cuda")
            rel = float(np.max(np.abs(r.objectives - seq.objectives)
                               / np.abs(seq.objectives)))
            pad_w = max(float(np.abs(st["w"][m:]).max(initial=0.0)) for st in job.steps)
            pad_kept = sum(int(st["fmask"][m:].sum()) for st in job.steps)
            m_b = job.group_key()[0]
            for k, st in enumerate(job.steps):
                if int(st["cap"]) >= m_b and int(st["n_iters"]) > 0:
                    mask_rate["serve_s_per_iter"].append(
                        float(st["solve_s"]) / int(st["n_iters"]))
            for k in range(len(seq.lambdas)):
                if int(seq.extras["caps"][k]) >= m and seq.solver_iters[k]:
                    mask_rate["scan_s_per_iter"].append(
                        float(seq.extras["solve_seconds"][k]) / int(seq.solver_iters[k]))
            jobs_out.append({"jid": job.jid, "shape": [m, n], "rules": job.rules,
                             "T": len(job.lambdas), "kept": r.kept.tolist(),
                             "caps": r.extras["caps"].tolist(),
                             "iters": r.solver_iters.tolist(),
                             "scan_iters": seq.solver_iters.tolist(),
                             "max_rel_obj_vs_scan": rel,
                             "latency_s": r.extras["latency_s"]})
            if rel > 1e-5:
                failures.append(f"job {job.jid}: rel {rel:.3e} against the scan path")
            if pad_w != 0.0 or pad_kept:
                failures.append(f"job {job.jid}: padded rows weight {pad_w}, kept {pad_kept}")
            if np.any(r.extras["caps"] > m) or np.any(r.kept > m):
                failures.append(f"job {job.jid}: caps or kept above m")
            if np.any(r.extras["health"]) or not np.all(np.isfinite(r.objectives)):
                failures.append(f"job {job.jid}: health {r.extras['health'].tolist()}")
            del Xt
    # safety: the smallest full-width tenant and the first EDPP tenant, each
    # against its unscreened path
    safety = []
    for job, r in ((groups[0][-1], results[0][-1]), (groups[1][0], results[1][0])):
        lams = job.lambdas[:SAFETY_STEPS]
        full = svm_path(job.X.contiguous(), job.y, lambdas=lams, engine="scan",
                        reduce="compact", screening=False, device="cuda")
        for k in range(1, len(lams)):
            support, missed = missed_features(full, k, r.extras["keep_masks"][k])
            safety.append({"jid": job.jid, "rules": job.rules, "step": k,
                           "support": support, "kept": int(r.kept[k]), "missed": missed})
            if missed:
                failures.append(f"serve safety, job {job.jid} step {k}: {missed} screened")
    gib = 2.0 ** 30
    emit({"phase": "serve", "slots": SERVE_SLOTS, "groups": [
              {"tenants": [list(t) for t in tn], "bucket": list(g[0].group_key()[:2]),
               "slot_gib": g[0].group_key()[0] * g[0].group_key()[1] * 4 / gib,
               **summ} for tn, g, summ in zip((SERVE_TENANTS, SERVE_EDPP_TENANTS),
                                              groups, summaries)],
          "cache": cache, "peak_gib": peak / gib, "launches": launches,
          "launches_by_group": [p[0] for p in parts],
          "skipped": skipped, "variants": variants, "jobs": jobs_out, "safety": safety,
          "mask_mode_s_per_iter": {k: (float(np.median(v)) if v else None)
                                   for k, v in mask_rate.items()},
          "padded_bytes_over_true": [
              g[0].group_key()[0] * g[0].group_key()[1] / float(t[0] * t[1])
              for g, t in ((groups[0], SERVE_TENANTS[0]),)],
          "breakdown_full_width_group": breakdown})
    emit({"phase": "serve_kernels", **at_shapes})
    require(not failures, "; ".join(failures))
    return dict(launches, **{f"skipped_{k}": v for k, v in skipped.items()}), at_shapes


def phase_serve_snapshot(PathServer, demo_jobs, faults) -> None:
    """The path server on the card at the bench size (4 tenants of 2,000 x
    400, 2 slots, snapshots every step): killed after 4 steps
    (``kill_server_after``) and served again from its snapshots, the
    results equal an uninterrupted serve's bit for bit (weights,
    objectives, health words)."""
    def jobs():
        return demo_jobs(4, m=2000, n=400, seed=0)

    ref = PathServer(slots=2, device="cuda").serve(jobs(), log=_quiet)
    with tempfile.TemporaryDirectory() as sd:
        crashed = PathServer(slots=2, device="cuda")
        crashed._step_hook = faults.kill_server_after(4)
        try:
            crashed.serve(jobs(), log=_quiet, snapshot_dir=sd, snapshot_every=1)
            killed = False
        except faults.ServerKilled:
            killed = True
        del crashed
        t0 = time.perf_counter()
        resumed = PathServer(slots=2, device="cuda").serve(
            jobs(), log=_quiet, snapshot_dir=sd, snapshot_every=1)
        wall = time.perf_counter() - t0
    bits = [all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("objectives", "weights", "kept"))
            and np.array_equal(a.extras["health"], b.extras["health"])
            for a, b in zip(ref, resumed)]
    emit({"phase": "serve_snapshot", "killed_after_steps": 4, "killed": killed,
          "resumed_wall_s": wall, "bitwise": bits})
    require(killed and all(bits), f"serve_snapshot: killed {killed}, bitwise {bits}")


def phase_serve_faults(PathServer, demo_jobs, faults) -> None:
    """The server's fault handling on the card at the bench size: a tenant
    poisoned with no retry left is quarantined while the other three
    finish; a transient poison is retried and every job ends within 1e-4
    of the clean serve; a job past its deadline is evicted."""
    def jobs():
        return demo_jobs(4, m=2000, n=400, seed=0)

    clean = PathServer(slots=2, device="cuda").serve(jobs(), log=_quiet)
    out = {"phase": "serve_faults"}
    q = jobs()
    for j in q:
        j.max_retries = 0
    srv = PathServer(slots=2, device="cuda")
    srv._fault_injector = faults.poison_server_slot(slot=0, at_step=2)
    res = srv.serve(q, log=_quiet)
    failed = [j.jid for j in q if j.status == "failed"]
    out["quarantine"] = {"failed": failed, "errors": [j.error for j in q if j.error],
                         "finished": sum(r is not None for r in res)}
    require(len(failed) == 1 and sum(r is not None for r in res) == 3,
            f"serve quarantine: {out['quarantine']}")
    srv = PathServer(slots=2, device="cuda")
    srv._fault_injector = faults.poison_server_slot(slot=0, at_step=3)
    res = srv.serve(jobs(), log=_quiet)
    diff = max(float(np.max(np.abs(a.objectives - b.objectives)))
               for a, b in zip(res, clean))
    out["retry"] = {"retries": srv.stats["retries"], "max_abs_obj_diff": diff}
    require(srv.stats["retries"] >= 1 and diff < 1e-4, f"serve retry: {out['retry']}")
    d = jobs()[:2]
    d[0].deadline_s = 0.0
    d[0].t_start = time.perf_counter() - 1.0
    res = PathServer(slots=2, device="cuda").serve(d, log=_quiet)
    out["deadline"] = {"status": d[0].status, "error": d[0].error,
                       "other_done": res[1] is not None}
    require(d[0].status == "failed" and res[0] is None and res[1] is not None,
            f"serve deadline: {out['deadline']}")
    emit(out)


def phase_scan_dynamic(svm_path, ops, chunk_iters, X, y, res_scan, full) -> dict:
    """The scan path of :func:`phase_scan_path` with dynamic screening
    every SCREEN_EVERY iterations (the refresh on the card between graph
    replays, one fetch a segment). Checked: the kernels launched (the
    dynamic variant once a segment), no guard trip or refused refresh,
    objectives within rel 1e-4 of float64 and rel 1e-5 of the sequential
    scan path, safety against the unscreened path, the fetch bound."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = svm_path(X, y, engine="scan", reduce="compact", dynamic=True,
                   screen_every=SCREEN_EVERY, n_lambdas=N_LAMBDAS,
                   lam_min_ratio=LAM_MIN_RATIO, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, skipped = ops.launch_counts(), ops.skipped_counts()
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds",
                                          "screen_bounds_dynamic")),
            f"a kernel of the dynamic scan path was never launched: {launches}")
    segments = res.extras["host_fetches"]["segment"]
    require(launches["screen_bounds_dynamic"] == segments,
            f"dynamic scan: {launches['screen_bounds_dynamic']} refresh launches for "
            f"{segments} segments")
    variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad"), "dynamic scan")
    require(not np.any(res.extras["health"]), f"health {res.extras['health']}")
    rel = float(np.max(np.abs(res.objectives - res_scan.objectives)
                       / np.abs(res_scan.objectives)))
    emit({"phase": "scan_dynamic", "shape": [int(X.shape[0]), int(X.shape[1])],
          "screen_every": SCREEN_EVERY, **scan_summary(res, wall, launches, skipped),
          "max_rel_obj_vs_sequential_scan": rel, "variants": variants})
    phase_objective_check(res, X, y, "scan_dynamic_objective_f64")
    require(rel <= 1e-5, f"dynamic vs sequential scan path: rel {rel:.3e}")
    require_fetch_bound(res, chunk_iters, "dynamic scan path")
    for k in range(1, len(full.lambdas)):
        support, missed = missed_features(full, k, res.extras["keep_masks"][k])
        require(missed == 0, f"dynamic scan step {k}: {missed} active features screened")
    return dict(launches, **{f"skipped_{k}": v for k, v in skipped.items()})


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def phase_chunked_path(PathDriver, svm_path, ops, sparse, screen_mod, shared_scalars,
                       screen_bounds, theta_fn, X_host, X, y, res, full, L) -> dict:
    """The feature path over the full-width X as host chunks of CHUNK_M rows
    (``FeatureChunked.from_dense``: 25 chunks of 82 MB, streamed through the
    pinned double buffer), with the in-core path's L.

    Checked: the feature-screen kernel launched (once per live chunk), the
    margin and gradient kernels' bulk variant on the gathered blocks; step
    1's bounds equal, bit for bit, the in-core kernel launch at the same
    anchor and lambdas (the kernel sums a row the same way whatever m it
    is given); no feature active in the unscreened path (``full``) was
    screened; objectives against float64 and within rel 1e-5 of the
    in-core path ``res``. Printed: kept counts beside ``res``'s, the stream
    stats, the parts' walls, the walls in turns with the in-core path
    (in-core, chunked, in-core; the chunked turn is the checked run), and
    the screen kernel's ms on one chunk (with its d_theta output) per call
    and by device time, beside ``torch.mv(chunk, y theta)``'s and the
    chunk's bound."""
    fc = sparse.FeatureChunked.from_dense(X_host, chunk_m=CHUNK_M)

    def incore():
        t0 = time.perf_counter()
        svm_path(X, y, n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = [incore()]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_ch = PathDriver("feature_vi", L=L, device="cuda").run(
        fc, y, n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    launches = ops.launch_counts()
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds")),
            f"chunked path: a kernel of the path was never launched: {launches}")
    variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad"), "chunked path")
    walls.append(incore())
    live = res_ch.extras["live_chunks"]
    require(launches["screen_bounds"] == int(live[1:].sum()),
            f"chunked path: {launches['screen_bounds']} screen launches, "
            f"{int(live[1:].sum())} live chunks")
    lam0, lam1 = float(res_ch.lambdas[0]), float(res_ch.lambdas[1])
    theta0 = theta_fn(y, lam0)
    core = screen_bounds(X, y, lam0, lam1, theta0, delta=torch.zeros((), device="cuda"))
    require(np.array_equal(res_ch.extras["bounds"][1], core.cpu().numpy()),
            "chunked path: step 1's bounds differ from the in-core kernel's")
    grid_equal = bool(np.array_equal(res_ch.lambdas, res.lambdas))
    out = []
    for k in range(1, SAFETY_STEPS):
        support, missed = missed_features(full, k, res_ch.extras["keep_masks"][k])
        out.append({"step": k, "support": support, "missed": missed})
        require(missed == 0, f"chunked step {k}: {missed} active features screened out")
    phase_objective_check(res_ch, X, y, phase="chunked_objective_f64")
    chunk = X[:CHUNK_M]
    sh = shared_scalars(y, lam0, lam1, theta0)
    packed = screen_mod.pack_shared(sh).cuda()
    screen_ms = timed_ms(lambda: screen_mod.screen_bounds_from_shared(
        chunk, y, theta0, sh, want_d_theta=True, scalars=packed), 50)
    dev_t = screen_device_times(screen_mod, chunk, y, theta0, packed, None, False,
                                "screen_bounds", 50, want_d_theta=True)
    rel = np.abs(res_ch.objectives - res.objectives) / np.abs(res.objectives)
    require(float(rel.max()) <= 1e-5,
            f"chunked path vs in-core path: rel {float(rel.max()):.3e}")
    emit({"phase": "chunked_path", "chunks": fc.n_chunks, "chunk_m": CHUNK_M,
          "lam_max_chunked": res_ch.extras["lam_max"],
          "lam_max_in_core": res.extras["lam_max"], "grid_equal": grid_equal,
          "step1_bounds_bitwise": True, "safety": out,
          "kept": res_ch.kept.tolist(), "kept_in_core": res.kept.tolist(),
          "live_chunks": live.tolist(), "iters": res_ch.solver_iters.tolist(),
          "max_rel_obj_vs_in_core": float(rel.max()),
          "stream_stats": res_ch.extras["stream_stats"],
          "part_walls_s": {k: v.tolist() for k, v in res_ch.extras["part_times"].items()},
          "walls_s": {"order": "in-core, chunked, in-core", "s": walls},
          "screen_ms_per_chunk": screen_ms,
          "screen_bound_ms_per_chunk": CHUNK_M * X.shape[1] * 4 / HBM_BYTES_PER_S * 1e3,
          **{f"screen_{k}_per_chunk": v for k, v in dev_t.items()},
          "launches": launches, "variants": variants})
    return launches


def make_news20_like(m, n, nnz, seed=0, planted=16, head=2000, noise=0.25):
    """A text-like CSR matrix over feature rows, at the shape of LIBSVM's
    news20.binary, from ``seed``, never dense: per-feature nonzero counts
    follow a Zipf law ``min(n, 1 + floor(C / rank))`` (C fitted so the
    counts sum to ``nnz``), features in a seeded random order, each row's
    samples distinct and sorted; values standard normal, each row scaled
    by its standard deviation over all n entries (zeros included), as
    ``make_sparse_classification``'s sparse branch scales; labels the
    median split of ``X^T w_true + noise``, ``w_true`` planted (2 x standard
    normal) on ``planted`` of the ``head`` most frequent features. Returns
    ``((data fp32, indices int32, indptr int64), y fp32)``."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, m + 1, dtype=np.float64)

    def counts_at(c):
        return np.minimum(n, 1 + np.floor(c / ranks))

    lo, hi = 0.0, float(n) * m
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if counts_at(mid).sum() < nnz else (lo, mid)
    counts = counts_at(lo).astype(np.int64)
    counts[np.nonzero(counts < n)[0][:nnz - int(counts.sum())]] += 1
    counts = counts[rng.permutation(m)]
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    rows = np.repeat(np.arange(m), counts)
    cols = rng.integers(0, n, size=nnz)
    heavy = np.nonzero(counts > n // 4)[0]
    for r in heavy:
        cols[indptr[r]:indptr[r + 1]] = rng.choice(n, counts[r], replace=False)
    light = np.ones(nnz, bool)
    for r in heavy:
        light[indptr[r]:indptr[r + 1]] = False
    while True:  # redraw repeated (row, column) pairs until there are none
        key = rows * n + cols
        order = np.argsort(key, kind="stable")
        dup = np.zeros(nnz, bool)
        dup[order[1:]] = key[order[1:]] == key[order[:-1]]
        dup &= light
        if not dup.any():
            break
        cols[dup] = rng.integers(0, n, size=int(dup.sum()))
    cols = cols[np.lexsort((cols, rows))]
    vals = rng.standard_normal(nnz)
    s1 = np.add.reduceat(vals, indptr[:-1])
    s2 = np.add.reduceat(vals * vals, indptr[:-1])
    std = np.sqrt(np.maximum(s2 / n - (s1 / n) ** 2, 0.0))
    vals /= (std + 1e-12)[rows]
    top = np.argsort(-counts, kind="stable")[:head]
    chosen = rng.choice(top, planted, replace=False)
    w_true = rng.standard_normal(planted) * 2.0
    scores = noise * rng.standard_normal(n)
    for r, wj in zip(chosen, w_true):
        lo_, hi_ = indptr[r], indptr[r + 1]
        scores[cols[lo_:hi_]] += wj * vals[lo_:hi_]
    y = np.where(scores >= np.median(scores), 1.0, -1.0)
    return (vals.astype(np.float32), cols.astype(np.int32), indptr), y.astype(np.float32)


def csr_f64_products(data64, cols, indptr, w, b, y):
    """Host float64 ``(objective parts)``: ``xi`` over all samples from the
    support of ``w``, and every feature's ``f_j^T (y xi)``."""
    u = np.zeros(y.shape[0])
    supp = np.nonzero(w)[0]
    for r in supp:
        lo, hi = indptr[r], indptr[r + 1]
        u[cols[lo:hi]] += data64[lo:hi] * w[r]
    xi = np.maximum(0.0, 1.0 - y * (u + b))
    corr = np.add.reduceat(data64 * (y * xi)[cols], indptr[:-1])
    corr[np.diff(indptr) == 0] = 0.0
    return xi, corr


def phase_chunked_sparse_path(PathDriver, ops, sparse, screen_mod, shared_scalars,
                              theta_fn) -> dict:
    """The feature path over a news20-shaped text-like instance
    (:func:`make_news20_like`, seed 0) too large for the card as a dense
    matrix: generated as CSR, saved with ``save_store`` to a temporary
    directory and reopened with ``from_store`` (memmap views, crc32 checked
    as each chunk is first used), CHUNK_M rows a chunk (662 chunks, every
    one a CSR chunk on the device), 8 lambdas down to NEWS20_RATIO, with L
    from ``lipschitz_estimate_stream`` over the same store at LIP_CHUNK_M
    rows a chunk (timed apart, then given to both runs).

    Checked: no put larger than CHUNK_M rows; the phase's peak device memory
    under 1.5 x (2 chunks in flight + the densify buffer + the largest
    gathered block + VECTORS (m + n) fp32 vectors); objectives against a
    float64 recomputation from the CSR on the host (rel 1e-4); at each
    accepted solution every screened feature has ``|f_j^T (y xi)| <=
    lam (1 + 1e-3)`` in float64 (the KKT condition of a zero weight);
    chunks skipped; the ``chunk_skip=False`` twin gives the same keeps,
    bounds, weights and objectives bit for bit; the feature-screen kernel
    launched once per live chunk, the margin and gradient kernels' bulk
    variant. Printed: kept counts, live chunks per step, bytes put, the
    parts' walls, the screen's mean ms per chunk (a densified chunk, per
    call and by device time, beside ``torch.mv``'s) beside its bound and
    the ms of writing it densely."""
    m, n = NEWS20["m"], NEWS20["n"]
    t0 = time.perf_counter()
    (data, cols, indptr), y_np = make_news20_like(**NEWS20, seed=0)
    gen_s = time.perf_counter() - t0
    fc_mem = sparse.FeatureChunked.from_csr((data, cols, indptr, (m, n)), chunk_m=CHUNK_M)
    dense_gb = m * n * 4 / 1e9
    with tempfile.TemporaryDirectory(prefix="news20_store_") as store:
        t0 = time.perf_counter()
        fc_mem.save_store(store, y=y_np)
        save_s = time.perf_counter() - t0
        del fc_mem
        fc = sparse.FeatureChunked.from_store(store)
        n_chunks = fc.n_chunks
        max_put = max(fc._put_bytes(i) for i in range(n_chunks))
        y = torch.from_numpy(fc.labels).cuda()
        t0 = time.perf_counter()
        coarse = sparse.FeatureChunked.from_store(store, chunk_m=LIP_CHUNK_M)
        L = float(sparse.lipschitz_estimate_stream(coarse, "cuda"))
        lipschitz_s = time.perf_counter() - t0
        lip_stats = dict(coarse.stats)
        del coarse
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = PathDriver("feature_vi", L=L, device="cuda").run(
            fc, y, n_lambdas=N_LAMBDAS, lam_min_ratio=NEWS20_RATIO)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        variants = require_bulk(ops, launches, ("margin_obj", "hinge_grad"),
                                "chunked sparse path")
        peaks = [torch.cuda.max_memory_allocated() - base]
        del fc  # its memoized reductions and dense buffer
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        twin = PathDriver("feature_vi", L=L, chunk_skip=False, device="cuda").run(
            sparse.FeatureChunked.from_store(store), y, n_lambdas=N_LAMBDAS,
            lam_min_ratio=NEWS20_RATIO)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        peaks.append(torch.cuda.max_memory_allocated() - base)
        peak = max(peaks)
        # one chunk for the per-chunk timings
        chunk = next(iter(sparse.FeatureChunked.from_store(store).stream("cuda", [0])))[1]
    st, tw = res.extras["stream_stats"], twin.extras["stream_stats"]
    live = res.extras["live_chunks"]
    # peak device memory against its stated limit
    kept_max = int(res.kept[1:].max())
    gathered = (m if kept_max == m else min(_bucket(max(kept_max, 1)), m)) * n * 4
    limit = 1.5 * (2 * max_put + CHUNK_M * n * 4 + gathered + VECTORS * (m + n) * 4)
    # float64 objectives and the KKT condition of the screened features
    data64 = data.astype(np.float64)
    rel, kkt = [], []
    for k in range(len(res.lambdas)):
        lam = float(res.lambdas[k])
        xi, corr = csr_f64_products(data64, cols, indptr, res.weights[k],
                                    float(res.biases[k]), y_np.astype(np.float64))
        obj = 0.5 * float(xi @ xi) + lam * float(np.abs(res.weights[k]).sum())
        rel.append(abs(obj - res.objectives[k]) / abs(obj))
        if k:
            scr = ~res.extras["keep_masks"][k]
            kkt.append(float(np.abs(corr[scr]).max() / lam) if scr.any() else 0.0)
    twin_equal = {key: bool(np.array_equal(res.extras[key], twin.extras[key],
                                           equal_nan=True))
                  for key in ("keep_masks", "bounds")}
    twin_equal["weights"] = bool(np.array_equal(res.weights, twin.weights))
    twin_equal["objectives"] = bool(np.array_equal(res.objectives, twin.objectives))
    # the screen's time on one chunk (densified), and the densify's
    theta = theta_fn(y, float(res.lambdas[0]))
    sh = shared_scalars(y, float(res.lambdas[0]), float(res.lambdas[1]), theta)
    packed = screen_mod.pack_shared(sh).cuda()
    dense = chunk.dense()
    screen_ms = timed_ms(lambda: screen_mod.screen_bounds_from_shared(
        dense, y, theta, sh, want_d_theta=True, scalars=packed), 50)
    dev_t = screen_device_times(screen_mod, dense, y, theta, packed, None, False,
                                "screen_bounds", 50, want_d_theta=True)
    densify_ms = timed_ms(chunk.dense, 50)
    chunk_bytes = chunk.rows * n * 4
    emit({"phase": "chunked_sparse_path", "shape": [m, n], "nnz": int(indptr[-1]),
          "dense_fp32_gb": dense_gb, "chunks": n_chunks, "chunk_m": CHUNK_M,
          "generate_s": gen_s, "save_store_s": save_s, "L": L,
          "lipschitz_s": lipschitz_s, "lipschitz_chunk_m": LIP_CHUNK_M,
          "lipschitz_puts": lip_stats["puts"],
          "lam_max": res.extras["lam_max"], "lambdas": res.lambdas.tolist(),
          "kept": res.kept.tolist(), "active": res.active.tolist(),
          "live_chunks": live.tolist(), "iters": res.solver_iters.tolist(),
          "objectives": res.objectives.tolist(), "max_rel_f64": max(rel),
          "kkt_worst_screened_over_lam": kkt, "stream_stats": st,
          "twin_stream_stats": tw, "twin_bitwise_equal": twin_equal,
          "path_s": path_s, "twin_s": twin_s,
          "part_walls_s": {k: v.tolist() for k, v in res.extras["part_times"].items()},
          "peak_bytes": int(peak), "peak_bytes_run_twin": [int(p) for p in peaks],
          "peak_limit_bytes": int(limit),
          "peak_parts": {"max_put": max_put, "densify": CHUNK_M * n * 4,
                         "gathered": gathered, "vectors": VECTORS * (m + n) * 4},
          "screen_launches": launches["screen_bounds"],
          "screen_ms_per_chunk": screen_ms,
          "screen_bound_ms_per_chunk": chunk_bytes / HBM_BYTES_PER_S * 1e3,
          **{f"screen_{k}_per_chunk": v for k, v in dev_t.items()},
          "densify_ms_per_chunk": densify_ms, "chunk_rows": chunk.rows,
          "chunk_nnz": int(chunk.val.shape[0]), "launches": launches,
          "variants": variants})
    require(st["max_put_rows"] <= CHUNK_M, f"a put of {st['max_put_rows']} rows")
    require(all(launches[k] > 0 for k in ("margin_obj", "hinge_grad", "screen_bounds")),
            f"chunked sparse path: a kernel of the path was never launched: {launches}")
    require(launches["screen_bounds"] == int(live[1:].sum()),
            f"chunked sparse path: {launches['screen_bounds']} screen launches, "
            f"{int(live[1:].sum())} live chunks")
    require(st["chunks_skipped"] > 0, "chunked sparse path: no chunk skipped")
    require(st["csr_puts"] == st["puts"], f"chunked sparse path: dense puts {st}")
    require(all(twin_equal.values()),
            f"chunked sparse path: the full-stream twin differs: {twin_equal}")
    require(peak < limit, f"chunked sparse path: peak {peak} >= limit {limit}")
    require(max(kkt) <= 1 + 1e-3, f"a screened feature has |f^T (y xi)| = "
                                  f"{max(kkt):.6f} lam")
    require(max(rel) <= 1e-4, f"chunked sparse objective vs float64: rel {max(rel):.3e}")
    return launches


CHUNKED_SMALL_CASES = [
    # (label, rules, grid, FISTA iterations a step, options)
    ("feature_vi", "feature_vi", dict(n_lambdas=10, lam_min_ratio=0.05), 300, {}),
    ("edpp", "edpp", dict(n_lambdas=10, lam_min_ratio=0.05), 300, {}),
    ("dvi", "dvi", dict(n_lambdas=10, lam_min_ratio=0.05), 300, {}),
    ("composite", "composite", dict(n_lambdas=N_LAMBDAS, lam_min_ratio=COMPOSITE_RATIO),
     2000, {}),
    ("dynamic", "feature_vi", dict(n_lambdas=5, lam_min_ratio=0.05), 60,
     dict(dynamic=True, screen_every=20)),
]


def phase_chunked_small_vs_plain(PathDriver, FeatureChunked, lipschitz_estimate,
                                 make) -> None:
    """The bench instance (2000 x 400, seed 11), dense and at density 0.04
    (CSR chunks, written densely on the device), as chunks of 97 rows, on
    the card and on the CPU with the same L, at fixed iterations (``tol=-1``;
    the composite grid at 2000 iterations, as
    :func:`phase_composite_small_vs_plain` says why; the dynamic path's
    streamed solver, which streams X twice an iteration, at 60 on 5
    lambdas with a refresh every 20). Checked: per-step objectives agree to
    rel 1e-6."""
    out = {"phase": "chunked_small_vs_plain", "shape": [2000, 400], "chunk_m": 97,
           "tol": 1e-6}
    for storage, density in (("dense", 1.0), ("csr", 0.04)):
        ds = make(m=2000, n=400, seed=11, density=density)
        L = float(lipschitz_estimate(torch.from_numpy(ds.X)))

        def fc():
            return (FeatureChunked.from_dense(ds.X, chunk_m=97) if ds.csr is None
                    else FeatureChunked.from_csr(ds.csr, chunk_m=97))

        for label, rules, grid, iters, opts in CHUNKED_SMALL_CASES:
            kw = dict(L=L, tol=-1.0, max_iters=iters, **opts)
            t0 = time.perf_counter()
            gpu = PathDriver(rules, device="cuda", **kw).run(fc(), ds.y, **grid)
            t1 = time.perf_counter()
            cpu = PathDriver(rules, device="cpu", **kw).run(fc(), ds.y, **grid)
            rel = float((np.abs(gpu.objectives - cpu.objectives)
                         / np.abs(cpu.objectives)).max())
            out[f"{storage}_{label}"] = {
                "iters": iters, "max_rel_obj": rel, "card_s": t1 - t0,
                "cpu_s": time.perf_counter() - t1,
                "kept_card": gpu.kept.tolist(), "kept_cpu": cpu.kept.tolist(),
                "kept_samples_card": gpu.kept_samples.tolist(),
                "csr_puts_card": gpu.extras["stream_stats"]["csr_puts"]}
            require(rel <= 1e-6, f"chunked {storage} {label}: card vs CPU at {iters} "
                                 f"iterations per step: rel {rel:.3e}")
    emit(out)


def host_lane(PathDriver, AutoRule, grid, X, y, L, kw, device) -> tuple:
    """The launcher's host lane on this rank of ``grid``:
    ``PathDriver(grid=grid, reduce="mask")`` with ``kw`` (``rules``, the
    solver options and the lambda grid; ``exact_lipschitz`` drops the path's
    L). Returns the result and, for ``auto``, the policy's decisions per step
    (extra sweep run, extra sweep on next, extra features screened)."""
    kw = dict(kw)
    path_kw = {k: kw.pop(k) for k in ("n_lambdas", "lam_min_ratio")}
    if kw["rules"] == "auto":
        kw["rules"] = AutoRule()
    if not kw.get("exact_lipschitz"):
        kw["L"] = L
    res = PathDriver(grid=grid, reduce="mask", device=device, **kw).run(X, y, **path_kw)
    decisions = None
    if isinstance(kw["rules"], AutoRule):
        decisions = [(t["extra_swept"], t["use_extra"], t["extra_screened"])
                     for t in kw["rules"].telemetry]
    return res, decisions


class Interrupted(RuntimeError):
    """Raised by :func:`stop_at`'s injector."""


def stop_at(k: int):
    """A ``PathDriver._fault_injector`` that interrupts the path in step
    ``k``, after its solve and before its certificate and checkpoint."""
    def injector(step, w, b):
        if step == k:
            raise Interrupted(f"step {k}")
        return w, b
    return injector


def phase_checkpoint_resume(PathDriver, ops, X, y, L) -> None:
    """The full-width feature path (gather, GRID_ITERS iterations a step)
    with a checkpoint directory in a temporary directory, interrupted in
    step 4 by an injected exception and resumed: weights, objectives and
    kept counts bit for bit the uninterrupted path's. Prints the seconds
    and bytes of each save."""
    t0 = time.perf_counter()
    kw = dict(L=L, tol=-1.0, max_iters=GRID_ITERS, device="cuda")
    grid = dict(n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO)
    full = PathDriver("feature_vi", **kw).run(X, y, **grid)
    with tempfile.TemporaryDirectory() as d:
        drv = PathDriver("feature_vi", ckpt_dir=d, **kw)
        drv._fault_injector = stop_at(STOP_STEP)
        t1 = time.perf_counter()
        try:
            drv.run(X, y, **grid)
            require(False, "checkpoint_resume: the injected interruption never fired")
        except Interrupted:
            pass
        interrupted_s = time.perf_counter() - t1
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        res = PathDriver("feature_vi", ckpt_dir=d, **kw).run(X, y, **grid)
        resumed_s = time.perf_counter() - t1
        launches = ops.launch_counts()
    ck = res.extras["checkpoint"]
    same = {"weights": bool(np.array_equal(res.weights, full.weights)),
            "biases": bool(np.array_equal(res.biases, full.biases)),
            "objectives": bool(np.array_equal(res.objectives, full.objectives)),
            "kept": bool(np.array_equal(res.kept, full.kept)),
            "keep_masks": bool(np.array_equal(res.extras["keep_masks"],
                                              full.extras["keep_masks"]))}
    emit({"phase": "checkpoint_resume", "shape": list(X.shape), "iters": GRID_ITERS,
          "resumed_at": ck["resumed_at"], "bitwise": same, "kept": res.kept.tolist(),
          "save_s": ck["seconds"], "save_bytes": ck["bytes"],
          "uninterrupted_wall_s": float(full.wall_times.sum()),
          "interrupted_s": interrupted_s, "resumed_s": resumed_s,
          "launches_resumed": launches, "seconds": time.perf_counter() - t0})
    require(ck["resumed_at"] == STOP_STEP, f"resumed at {ck['resumed_at']}")
    require(all(same.values()), f"resumed path differs from the uninterrupted one: {same}")
    for name in ("margin_obj", "hinge_grad", "screen_bounds"):
        require(launches[name] > 0, f"checkpoint_resume: {name} never launched")


def phase_faults(PathDriver, sparse, faults, ops, res, full, X, y) -> None:
    """``poison_path_step(2)`` on the full-width feature path (default stop
    rule): step 3's certificate is refused and it keeps all m features,
    screening stays safe against the unscreened path, and every other
    step's objective is within rel 1e-4 of the clean path's. Then a small
    store (the bench instance, 256-row chunks) with chunk 1 corrupted: the
    streamed screen raises ``StoreCorruptError`` before any screen kernel
    launches, and the launcher, run as a process on it, exits 2 with no
    traceback."""
    from repro_torch.core.solver import HEALTH_SCREEN_REFUSED
    from repro_torch.data import make_sparse_classification

    t0 = time.perf_counter()
    drv = PathDriver("feature_vi", device="cuda")
    drv._fault_injector = faults.poison_path_step(2)
    ops.reset_launch_counts()
    p = drv.run(X, y, lambdas=res.lambdas)
    launches = ops.launch_counts()
    m = X.shape[0]
    health = p.extras["health"]
    rel = [float(abs(p.objectives[k] - res.objectives[k]) / abs(res.objectives[k]))
           for k in range(len(res.lambdas)) if k != 2]
    missed = [missed_features(full, k, p.extras["keep_masks"][k])[1]
              for k in range(1, SAFETY_STEPS)]
    out = {"phase": "faults", "shape": list(X.shape), "health": health.tolist(),
           "kept": p.kept.tolist(), "kept_clean": res.kept.tolist(),
           "max_rel_obj_vs_clean": max(rel), "tol": 1e-4, "missed": missed,
           "poisoned_wall_s": float(p.wall_times.sum()),
           "clean_wall_s": float(res.wall_times.sum())}
    require(bool(health[3] & HEALTH_SCREEN_REFUSED), f"step 3 not refused: {health}")
    require(int(p.kept[3]) == m, f"refused step 3 kept {p.kept[3]} of {m}")
    require(max(rel) <= 1e-4, f"poisoned path vs clean: rel {max(rel):.3e}")
    require(not any(missed), f"poisoned path screened used features {missed}")
    for name in ("margin_obj", "hinge_grad", "screen_bounds"):
        require(launches[name] > 0, f"faults: {name} never launched")

    ds = make_sparse_classification(m=2000, n=400, seed=11)
    with tempfile.TemporaryDirectory() as d:
        sd = f"{d}/store"
        sparse.FeatureChunked.from_dense(ds.X, chunk_m=256).save_store(sd, y=ds.y)
        faults.corrupt_store_bytes(f"{sd}/X.bin", offset=300 * ds.X.shape[1] * 4)
        fc = sparse.FeatureChunked.from_store(sd)
        yc = torch.from_numpy(ds.y).cuda()
        lmax = float(np.max(np.abs(ds.X @ (ds.y - ds.y.mean()))))
        ops.reset_launch_counts()
        try:
            sparse.screen_step_stream(fc, yc, lmax, 0.5 * lmax, torch.zeros_like(yc))
            raised = None
        except sparse.StoreError as e:
            raised = type(e).__name__
        screen_launches = ops.launch_counts()["screen_bounds"]
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train_svm", "--storage", "mmap",
             "--store-dir", sd, "--chunk-m", "256", "--device", "cuda"],
            cwd=d, env=env, capture_output=True, text=True, timeout=300)
    out.update(store_error=raised, store_screen_launches=screen_launches,
               launcher_rc=proc.returncode, launcher_stderr=proc.stderr.strip()[-300:],
               seconds=time.perf_counter() - t0)
    emit(out)
    require(raised == "StoreCorruptError", f"corrupt store: raised {raised}")
    require(screen_launches == 0, "the corrupt chunk reached the screen kernel")
    require(proc.returncode == 2, f"launcher on a corrupt store: exit {proc.returncode}")
    require("Traceback" not in proc.stderr + proc.stdout,
            "launcher on a corrupt store printed a traceback")


def busy_share(trace_path) -> tuple:
    """``(busy share, kernel names)`` of a ``torch.profiler`` Chrome trace:
    the union of the device's kernel, copy and set intervals inside the
    ``path`` region over its length, and the names of the kernels."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    region = next(e for e in events if e.get("name") == "path"
                  and e.get("cat") == "user_annotation")
    lo, hi = region["ts"], region["ts"] + region["dur"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, lo
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    return busy / max(hi - lo, 1e-9), names, [e["name"] for e in events
                                              if e.get("cat") == "user_annotation"]


def count_syncs(fn):
    """``(fn(), the synchronizing CUDA operations it ran)``: each host sync
    that ``torch.cuda.set_sync_debug_mode("warn")`` reports is one warning."""
    always = torch.is_warn_always_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.set_warn_always(True)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.set_warn_always(always)
    return out, sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def phase_trace(svm_path, obs_trace, train_main, X, y) -> None:
    """The full-width feature path with tracing off and on. Deterministic
    gates: the same count of host syncs with tracing off and on (one run
    each under ``torch.cuda.set_sync_debug_mode``), and in every traced run
    each step has its four ``path.*`` spans, whose lengths are the result's
    screen, solve, certify and step walls. Timed: TRACE_PAIRS pairs of an
    untraced and a traced run back to back (the order alternating); the
    overhead, the median of the pairs' on/off wall ratios less 1, stays
    under 2%. Then the launcher's ``--profile`` on the scan path and on
    the composite host path (PROFILE_SHAPE, in a temporary working
    directory): the kernels' names in the captures, the host path's
    regions named as its spans, and the card's busy share over each
    path."""
    t0 = time.perf_counter()
    kw = dict(n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO, device="cuda")
    spans_ok = True

    def traced():
        nonlocal spans_ok
        obs_trace.get_tracer().clear()
        obs_trace.enable()
        try:
            r = svm_path(X, y, **kw)
        finally:
            obs_trace.disable()
        evs = obs_trace.get_tracer().events
        pt = r.extras["path_trace"]
        for k in range(1, len(r.lambdas)):
            dur = {e["name"]: e["dur"] * 1e-6 for e in evs
                   if e["name"].startswith("path.") and e["args"].get("step") == k}
            want = {"path.screen": r.screen_times[k],
                    "path.solve": r.extras["solve_times"][k],
                    "path.certify": pt.steps[k].certify_s,
                    "path.step": r.wall_times[k]}
            spans_ok &= dur.keys() == want.keys() and all(
                abs(dur[n] - want[n]) <= 1e-6 * want[n] + 1e-9 for n in want)
        return r

    run = {"off": lambda: svm_path(X, y, **kw), "on": traced}
    _, syncs_off = count_syncs(run["off"])
    _, syncs_on = count_syncs(run["on"])
    walls = {"off": [], "on": []}
    for pair in range(TRACE_PAIRS):
        for mode in (("off", "on") if pair % 2 == 0 else ("on", "off")):
            t1 = time.perf_counter()
            run[mode]()
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t1)
    obs_trace.get_tracer().clear()
    ratios = np.asarray(walls["on"]) / np.asarray(walls["off"])
    overhead = float(np.median(ratios)) - 1.0
    spread = {"off_rel": float(np.ptp(walls["off"]) / np.median(walls["off"])),
              "ratio_q25": float(np.quantile(ratios, 0.25)),
              "ratio_q75": float(np.quantile(ratios, 0.75))}
    out = {"phase": "trace", "shape": list(X.shape), "pairs": TRACE_PAIRS,
           "walls_off_s": walls["off"], "walls_on_s": walls["on"],
           "overhead": overhead, "spread": spread, "limit": 0.02, "syncs_off": syncs_off, "syncs_on": syncs_on,
           "spans_match_walls": bool(spans_ok), "profiles": {}}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            for label, argv in (("scan", ["--engine", "scan"]),
                                ("host_composite", ["--rules", "composite", "--reduce",
                                                    "mask", "--lam-min-ratio", "0.02"])):
                t1 = time.perf_counter()
                rc = train_main(["--m", str(PROFILE_SHAPE["m"]), "--n",
                                 str(PROFILE_SHAPE["n"]), "--device", "cuda",
                                 "--profile", label, *argv])
                share, names, regions = busy_share(f"{d}/{label}/profile.json")
                out["profiles"][label] = {
                    "rc": rc, "busy_share": share, "seconds": time.perf_counter() - t1,
                    "kernels": sorted(n[:48] for n in names),
                    "regions": sorted(set(regions))}
        finally:
            os.chdir(cwd)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    require(spans_ok, "trace: a step's spans do not match its walls")
    require(syncs_on == syncs_off > 0,
            f"trace: {syncs_on} host syncs traced against {syncs_off} untraced")
    require(overhead < 0.02, f"trace: tracing costs {overhead:.2%} of the path wall "
            f"(median of {TRACE_PAIRS} pairs)")
    want = {"scan": ("margin_partial", "hinge_grad", "screen_sweep"),
            "host_composite": ("margin_partial", "hinge_grad", "screen_sweep",
                               "sample_partial")}
    for label, kernels in want.items():
        prof = out["profiles"][label]
        require(prof["rc"] == 0, f"--profile {label}: exit {prof['rc']}")
        for k in kernels:
            require(any(k in n for n in prof["kernels"]),
                    f"--profile {label}: no {k} kernel in the capture")
    for region in ("path.screen", "path.solve", "path.certify", "path.step"):
        require(region in out["profiles"]["host_composite"]["regions"],
                f"--profile host_composite: no {region} region")


def grid_rank(grid, arrays, cfg) -> dict:
    """One rank of the sharded phases (spawned: ``core/distributed.py``
    ``run_grid``, gloo; the ranks share the one card, or run on the CPU).
    Copies its block of the memory-mapped X to its device; with ``lam1``,
    step 1's screen from the closed-form anchor (``screen_sharded``); with
    ``path``, the sharded scan path; with ``host``, the launcher's host lane
    (``PathDriver(grid=grid, reduce="mask")``, composite); with ``small``,
    the bench instance's paths (feature_vi, edpp, dvi on the scan lane,
    composite on the host lane); with ``small_lanes``, the bench instance's
    host lanes by name (:func:`host_lane`). Each path runs with the launch
    counts set to 0 just before it and read just after."""
    from repro_torch.core import distributed as D
    from repro_torch.core.path import PathDriver
    from repro_torch.core.path_scan import svm_path_scan_sharded
    from repro_torch.core.rules import AutoRule
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = cfg["device"]
    t_rank = time.perf_counter()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"rank": grid.rank, "backend": grid.backend, "runs": {}}

    def blocks(xk, yk):
        X = torch.from_numpy(np.array(grid.block(arrays[xk]))).to(dev)
        return X, torch.from_numpy(np.array(grid.col_block(arrays[yk]))).to(dev)

    def counted(label, fn):
        ops.reset_launch_counts()
        D.ALLREDUCE.update(calls=0, bytes=0)
        t0 = time.perf_counter()
        res = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        out["runs"][label] = {"wall_s": time.perf_counter() - t0,
                              "launches": ops.launch_counts(),
                              "allreduce": dict(D.ALLREDUCE)}
        return res

    if "lam1" in cfg:
        X, y = blocks("X", "y")
        theta0 = torch.from_numpy(np.array(grid.col_block(cfg["theta0"]))).to(dev)
        _, bounds = counted("screen", lambda: D.screen_sharded(
            grid, X, y, cfg["lmax"], cfg["lam1"], theta0, delta=0.0))
        out["bounds1"] = D.gather_rows(grid, bounds).cpu().numpy()
        if "path" in cfg:
            out["path"] = counted("path", lambda: svm_path_scan_sharded(
                grid, X, y, device=dev, L=cfg["L"], **cfg["path"]))
        if "host" in cfg:
            out["host"] = counted("host", lambda: host_lane(
                PathDriver, AutoRule, grid, X, y, cfg["L"],
                dict(rules="composite", **cfg["host"]), dev)[0])
            # each partial launch on the rank's block while the ranks share the card
            from repro_torch.kernels import hinge, screen
            w = torch.full((X.shape[0],), 0.01, device=dev)
            torch.distributed.barrier()
            out["partial_ms_shared_card"] = {
                "margin_partial": timed_ms(lambda: hinge.margin_partial_op(X, w), 20),
                "screen_partial": timed_ms(lambda: screen.screen_partial_op(X, y, y), 20),
                "sample_partial": timed_ms(lambda: screen.sample_partial_op(X, w), 20)}
        del X
    if "small" in cfg or "small_lanes" in cfg:
        X, y = blocks("Xs", "ys")
    if "small" in cfg:
        for rules in ("feature_vi", "edpp", "dvi"):
            out[f"small_{rules}"] = counted(f"small_{rules}", lambda: svm_path_scan_sharded(
                grid, X, y, rules=rules, device=dev, L=cfg["Ls"], **cfg["small"])).objectives
        out["small_composite"] = counted("small_composite", lambda: host_lane(
            PathDriver, AutoRule, grid, X, y, cfg["Ls"],
            dict(rules="composite", **cfg["small_composite"]), dev)[0]).objectives
    out["lanes"] = {}
    for name, kw in cfg.get("small_lanes", {}).items():
        res, decisions = counted(f"lane_{name}", lambda: host_lane(
            PathDriver, AutoRule, grid, X, y, cfg["Ls"], kw, dev))
        out["lanes"][name] = {"objectives": res.objectives, "kept": res.kept,
                              "keep_masks": res.extras["keep_masks"],
                              "decisions": decisions}
    out["wall_s"] = time.perf_counter() - t_rank
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    return out


def rank_report(outs, grid) -> list:
    """Per rank: wall, all-reduce calls and bytes, peak device memory, the
    backend and the partial-mode launches of each run."""
    partial = ("margin_partial", "margin_finalize", "screen_partial", "screen_finalize",
               "sample_partial", "sample_finalize")
    return [{"grid": f"{grid[0]}x{grid[1]}", "rank": o["rank"], "backend": o["backend"],
             "wall_s": o["wall_s"], "peak_bytes": o["peak_bytes"],
             "partial_ms_shared_card": o.get("partial_ms_shared_card"),
             "runs": {k: {"wall_s": v["wall_s"], **v["allreduce"],
                          "partial_launches": {p: v["launches"][p] for p in partial}}
                      for k, v in o["runs"].items()}} for o in outs]


def phase_sharded_unit_grid(svm_path_scan, svm_path_scan_sharded, svm_grid, ops, X, y,
                            L) -> tuple:
    """The sharded scan engine on a 1 x 1 grid in this process (a world of
    one: every collective is the identity) against ``svm_path_scan(reduce=
    "mask")`` on the feature path's grid at GRID_ITERS iterations a step
    (``tol=-1``), with the same L: keep masks, weights, biases, objectives,
    iterations and gaps bit for bit. Returns the single-device path (the
    sharded grids' reference) and the 1 x 1 run's launch counts."""
    t0 = time.perf_counter()
    kw = dict(n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO, max_iters=GRID_ITERS,
              tol=-1.0, L=L)
    single = svm_path_scan(X, y, reduce="mask", device="cuda", **kw)
    ops.reset_launch_counts()
    unit = svm_path_scan_sharded(svm_grid(1, 1), X, y, device="cuda", **kw)
    launches = ops.launch_counts()
    same = {
        "keep_masks": bool(np.array_equal(unit.extras["keep_masks"],
                                          single.extras["keep_masks"])),
        "weights": bool(np.array_equal(unit.weights, single.weights)),
        "biases": bool(np.array_equal(unit.biases, single.biases)),
        "objectives": bool(np.array_equal(unit.objectives, single.objectives)),
        "iterations": bool(np.array_equal(unit.solver_iters, single.solver_iters)),
        "gaps": bool(np.array_equal(unit.extras["gaps"], single.extras["gaps"])),
    }
    emit({"phase": "sharded_unit_grid", "shape": list(X.shape), "bitwise": same,
          "kept": unit.kept.tolist(), "launches": launches,
          "engine": unit.extras["engine"], "seconds": time.perf_counter() - t0})
    require(all(same.values()), f"1 x 1 sharded scan differs from svm_path_scan: {same}")
    for name in ("margin_obj", "hinge_grad", "screen_bounds"):
        require(launches[name] > 0, f"sharded_unit_grid: {name} never launched")
    return single, launches


def phase_sharded_grid(D, screen_bounds, lambda_max_fn, theta_fn, X, y, X_path, y_path,
                       single, full, composite, L, small) -> dict:
    """The grids 2 x 2, 4 x 1 and 1 x 4 as spawned ranks sharing the card
    (gloo over CUDA tensors; the parent saved X once, each rank maps it and
    copies its block). Step 1's screen from the closed-form anchor: 4 x 1
    bit for bit the single-device kernel's bounds, the others within
    rtol/atol 2e-4 and keeping every feature the unscreened solve uses. On
    2 x 2: the scan path at GRID_ITERS iterations a step (objectives within
    rel 1e-5 of the single-device scan path, safe against the unscreened
    path, objectives against float64) and the launcher's host lane with
    ``composite`` on the composite grid (screened samples at slack 0 in
    float64, objectives within rel 1e-5 of ``PathDriver(composite, mask)``
    at the same iterations); the 2 x 2 ranks also run the bench instance
    for :func:`phase_sharded_small_vs_plain`. Returns rank 0's 2 x 2 runs
    (launch counts) and the bench results."""
    t_phase = time.perf_counter()
    lams = single.lambdas
    lmax = lambda_max_fn(X, y)
    theta0 = theta_fn(y, lmax)
    want = screen_bounds(X, y, lmax, float(lams[1]), theta0).cpu().numpy()
    support, _ = missed_features(full, 1, np.ones(X.shape[0], bool))
    out = {"phase": "sharded_grid", "shape": list(X.shape), "iters": GRID_ITERS,
           "grids": {}}
    arrays = {"X": X_path, "y": y_path, "Xs": small["X"], "ys": small["y"]}
    path_kw = dict(n_lambdas=N_LAMBDAS, lam_min_ratio=LAM_MIN_RATIO,
                   max_iters=GRID_ITERS, tol=-1.0)
    host_kw = dict(n_lambdas=N_LAMBDAS, lam_min_ratio=COMPOSITE_RATIO,
                   max_iters=GRID_ITERS, tol=-1.0)
    keep2, lanes = None, {}
    for grid in GRIDS:
        t0 = time.perf_counter()
        cfg = dict(device="cuda", lmax=float(lmax), lam1=float(lams[1]),
                   theta0=theta0.cpu().numpy(), L=L, Ls=small["L"])
        if grid == (2, 2):
            cfg.update(path=path_kw, host=host_kw, small=GRID_SMALL,
                       small_composite=GRID_SMALL_COMPOSITE)
        if grid in GRID_LANES:
            cfg["small_lanes"] = GRID_LANES[grid]
        outs = D.run_grid(grid_rank, *grid, arrays, (cfg,), backend="gloo",
                          device="cuda", timeout=GRID_TIMEOUT_S)
        if grid in GRID_LANES:
            lanes[grid] = [{"lanes": o["lanes"], "runs": o["runs"]} for o in outs]
        for o in outs[1:]:
            require(np.array_equal(o["bounds1"], outs[0]["bounds1"]),
                    f"grid {grid}: ranks disagree on the bounds")
        got = outs[0]["bounds1"]
        keep = ~(got < 1.0 - 2e-3)
        g = {"seconds": time.perf_counter() - t0,
             "bounds_bitwise": bool(np.array_equal(got, want)),
             "bounds_max_abs_err": float(np.abs(got - want).max()),
             "kept_step1": int(keep.sum()),
             "missed_step1": int(np.sum(missed_features(full, 1, keep)[1])),
             "support_step1": support, "ranks": rank_report(outs, grid)}
        if grid[1] == 1:
            require(g["bounds_bitwise"], f"grid {grid}: step-1 bounds not bit for bit")
        else:
            require(np.allclose(got, want, rtol=2e-4, atol=2e-4),
                    f"grid {grid}: step-1 bounds off by {g['bounds_max_abs_err']:.3e}")
        require(g["missed_step1"] == 0, f"grid {grid}: step 1 screened an active feature")
        if grid == (2, 2):
            keep2 = outs[0]
            r = keep2["path"]
            rel = float(np.max(np.abs(r.objectives - single.objectives)
                               / np.abs(single.objectives)))
            missed = [missed_features(full, k, r.extras["keep_masks"][k])[1]
                      for k in range(1, SAFETY_STEPS)]
            g["path"] = {"max_rel_obj_vs_single": rel, "tol": 1e-5,
                         "kept": r.kept.tolist(), "kept_single": single.kept.tolist(),
                         "missed": missed, "wall_s": keep2["runs"]["path"]["wall_s"],
                         "single_wall_s": float(single.extras["total_seconds"])}
            require(rel <= 1e-5, f"2 x 2 scan path vs single device: rel {rel:.3e}")
            require(not any(missed), f"2 x 2 scan path screened active features {missed}")
            phase_objective_check(r, X, y, "sharded_path_objective_f64")
            h = keep2["host"]
            rel_h = float(np.max(np.abs(h.objectives - composite.objectives)
                                 / np.abs(composite.objectives)))
            rel64, xi_scr = screened_slack_f64(h, X, y)
            g["host"] = {"max_rel_obj_vs_single": rel_h, "tol": 1e-5,
                         "kept": h.kept.tolist(), "kept_samples": h.kept_samples.tolist(),
                         "kept_samples_single": composite.kept_samples.tolist(),
                         "verify_rounds": h.verify_rounds.tolist(),
                         "max_rel_obj_f64": rel64, "worst_screened_xi": xi_scr,
                         "wall_s": keep2["runs"]["host"]["wall_s"]}
            require(rel_h <= 1e-5, f"2 x 2 host lane vs PathDriver: rel {rel_h:.3e}")
            require(int(h.kept_samples.min()) < X.shape[1],
                    "2 x 2 host lane screened no sample")
            for run in ("path", "host"):
                la = keep2["runs"][run]["launches"]
                for name in ("margin_partial", "margin_finalize", "hinge_grad",
                             "screen_partial", "screen_finalize"):
                    require(la[name] > 0, f"2 x 2 {run}: {name} never launched")
            require(keep2["runs"]["host"]["launches"]["sample_partial"] > 0
                    and keep2["runs"]["host"]["launches"]["sample_finalize"] > 0,
                    "2 x 2 host lane: the sample kernel's partial mode never launched")
        out["grids"][f"{grid[0]}x{grid[1]}"] = g
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return keep2, lanes


def phase_host_lane_grid(PathDriver, svm_path_scan, keep2, lanes, small) -> None:
    """The host lane on a grid through ``PathDriver(grid=..., reduce="mask")``
    (the launcher's ``run_path`` is gone): the full-width 2 x 2 composite
    lane's wall (checked in :func:`phase_sharded_grid`), and on the bench
    instance on GRID_LANE (fixed iterations) ``edpp`` and ``dvi`` on 2 x 2
    and 1 x 4, ``auto`` and ``--exact-lipschitz`` on 2 x 2, each against
    single-device ``PathDriver(reduce="mask")`` on the card at the
    tolerances of ``tests/test_torch_distributed.py`` (objectives within rel
    1e-6, step 1's keep mask equal), every rank alike, safe against the
    unscreened path, and ``auto``'s decisions the same on every rank."""
    t0 = time.perf_counter()
    Xs, ys = small["X"], small["y"]
    path_kw = {k: GRID_LANE[k] for k in ("n_lambdas", "lam_min_ratio")}
    solve_kw = {k: GRID_LANE[k] for k in ("max_iters", "tol")}
    full = svm_path_scan(Xs, ys, screening=False, L=small["L"], device="cuda",
                         max_iters=20_000, tol=1e-12, **path_kw)
    support = np.abs(full.weights) > 1e-6
    h = keep2["runs"]["host"]
    out = {"phase": "host_lane_grid", "shape_full": "50000x10000",
           "full_2x2_composite": {"wall_s": h["wall_s"],
                                  "allreduce_calls": h["allreduce"]["calls"]},
           "shape_small": list(Xs.shape), "tol": 1e-6, "lanes": {}}
    for grid, ranks in lanes.items():
        tag = f"{grid[0]}x{grid[1]}"
        for name, kw in GRID_LANES[grid].items():
            kw = {k: v for k, v in kw.items() if k not in path_kw and k not in solve_kw}
            if not kw.get("exact_lipschitz"):
                kw["L"] = small["L"]
            single = PathDriver(reduce="mask", device="cuda", **solve_kw, **kw).run(
                Xs, ys, **path_kw)
            got = ranks[0]["lanes"][name]
            for r in ranks[1:]:
                require(np.array_equal(r["lanes"][name]["objectives"], got["objectives"])
                        and r["lanes"][name]["decisions"] == got["decisions"],
                        f"{tag} {name}: ranks disagree")
            rel = float(np.max(np.abs(got["objectives"] - single.objectives)
                               / np.abs(single.objectives)))
            missed = int(np.sum(support & ~got["keep_masks"]))
            la = ranks[0]["runs"][f"lane_{name}"]
            out["lanes"][f"{name}_{tag}"] = {
                "max_rel_obj_vs_single": rel, "kept": got["kept"].tolist(),
                "kept_single": single.kept.tolist(), "missed": missed,
                "step1_mask_equal": bool(np.array_equal(
                    got["keep_masks"][1], single.extras["keep_masks"][1])),
                "decisions_rank0": got["decisions"], "wall_s": la["wall_s"],
                "allreduce_calls": la["allreduce"]["calls"],
                "screen_launches": int(sum(la["launches"][k] for k in (
                    "screen_bounds", "screen_bounds_edpp", "screen_partial")))}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    for key, v in out["lanes"].items():
        require(v["max_rel_obj_vs_single"] <= 1e-6,
                f"host lane {key} vs PathDriver: rel {v['max_rel_obj_vs_single']:.3e}")
        require(v["step1_mask_equal"], f"host lane {key}: step 1 keeps differ")
        require(v["missed"] == 0, f"host lane {key}: screened {v['missed']} used features")
        require(min(v["kept"][1:]) < Xs.shape[0], f"host lane {key}: nothing screened")
        require(v["screen_launches"] > 0, f"host lane {key}: the screen never launched")
    require(any(s for s, _, _ in out["lanes"]["auto_2x2"]["decisions_rank0"]),
            "auto on 2 x 2: no probe ran the extra sweep")


def phase_sharded_small_vs_plain(D, card) -> None:
    """The bench instance (2000 x 400, seed 11) on the 2 x 2 grid: card
    ranks (from :func:`phase_sharded_grid`) against CPU ranks (gloo on the
    CPU, the plain versions), the same L, at 60 FISTA iterations a step:
    ``feature_vi``, ``edpp``, ``dvi`` on the scan lane and ``composite`` on
    the host lane, objectives within rel 1e-6."""
    t0 = time.perf_counter()
    small = card["small_inputs"]
    cfg = dict(device="cpu", small=GRID_SMALL, small_composite=GRID_SMALL_COMPOSITE,
               Ls=small["L"])
    cpu = D.run_grid(grid_rank, 2, 2, {"Xs": small["X"], "ys": small["y"]}, (cfg,),
                     backend="gloo", device="cpu", timeout=GRID_TIMEOUT_S)[0]
    out = {"phase": "sharded_small_vs_plain", "shape": list(small["X"].shape),
           "grid": "2x2", "tol": 1e-6}
    for key in ("small_feature_vi", "small_edpp", "small_dvi", "small_composite"):
        rel = float(np.max(np.abs(card[key] - cpu[key]) / np.abs(cpu[key])))
        out[key] = {"max_rel_obj": rel, "card_wall_s": card["runs"][key]["wall_s"],
                    "cpu_wall_s": cpu["runs"][key]["wall_s"]}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    for key, v in out.items():
        if isinstance(v, dict):
            require(v["max_rel_obj"] <= 1e-6, f"{key}: card vs CPU rel {v['max_rel_obj']:.3e}")


def phase_partial_timing(hinge, screen, shared_scalars, edpp_scalars, X, y) -> dict:
    """Each partial mode on the full-width block of a 2 x 2 grid (25,000 x
    5,000 fp32), its plain version and the library call (the feature
    screen's: ``torch.mv(X, y theta)``, d_theta only; the screen and its
    library call also by device time), its finalize, the error against the
    plain sums, and the least time the card could take;
    and a partial launch then its finalize on that block against the full
    launch, bit for bit (the 1 x 1 contract at the block's shape)."""
    m, n = X.shape[0] // 2, X.shape[1] // 2
    Xb = X[:m, :n].contiguous()
    yb = y[:n].contiguous()
    g = torch.Generator().manual_seed(5)
    w = (torch.randn(m, generator=g) * 0.01).cuda()
    theta = (torch.rand(n, generator=g) / 5.0).cuda()
    b = torch.tensor(0.1, device="cuda")
    sh = shared_scalars(yb, 5.0, 3.0, theta, delta=1e-3)
    e = edpp_scalars(yb, 5.0, 3.0, theta, delta=1e-3)
    u_part = hinge.margin_partial_op(Xb, w)
    sums = screen.screen_partial_op(Xb, yb, theta)
    pair = screen.sample_partial_op(Xb, w)
    bits = {
        "margin": all(torch.equal(p, q) for p, q in zip(
            hinge.margin_obj_op(Xb, w, yb, b), hinge.margin_finalize_op(u_part, yb, b))),
        "screen": torch.equal(screen.screen_bounds_from_shared(Xb, yb, theta, sh),
                              screen.screen_finalize_op(sums, sh)),
        "screen_edpp": torch.equal(screen.screen_bounds_edpp(Xb, yb, theta, sh, e),
                                   screen.screen_finalize_op(sums, sh, edpp=e)),
        "sample": all(torch.equal(p, q) for p, q in zip(
            screen.sample_surplus_op(Xb, w, yb, 0.13, 0.37, 0.05),
            screen.sample_finalize_op(pair, yb, 0.13, 0.37, 0.05))),
    }
    require(all(bits.values()), f"partial mode + finalize != full launch: {bits}")

    def err(got, want, scale, k):
        """The largest error of the sums, each held at its own terms' size
        (:func:`sums_error`)."""
        e_, ratio = sums_error(got, want, scale, k)
        require(ratio <= 1.0, f"partial mode vs plain: max_abs_err {e_:.3e} is "
                              f"{ratio:.2f} x its tolerance")
        return e_

    x_bytes = m * n * 4
    out = {
        "margin_obj": {
            "ms": timed_ms(lambda: hinge.margin_partial_op(Xb, w), 20),
            "finalize_ms": timed_ms(lambda: hinge.margin_finalize_op(u_part, yb, b), 20),
            "plain_ms": timed_ms(lambda: hinge.margin_partial_plain(Xb, w), 20),
            "library_ms": timed_ms(lambda: torch.mv(Xb.t(), w), 20),
            "bytes": x_bytes + m * 4 + n * 4, "flops": 2 * m * n,
            "max_abs_err": err(u_part, hinge.margin_partial_plain(Xb, w),
                               hinge.margin_partial_plain(Xb.abs(), w.abs()), m)},
        "screen_bounds": {
            "ms": timed_ms(lambda: screen.screen_partial_op(Xb, yb, theta), 20),
            "device_ms": device_ms(lambda: screen.screen_partial_op(Xb, yb, theta), 20),
            "finalize_ms": timed_ms(lambda: screen.screen_finalize_op(sums, sh), 20),
            "plain_ms": timed_ms(lambda: screen.screen_partial_plain(Xb, yb, theta), 20),
            "library_ms": timed_ms(lambda: torch.mv(Xb, yb * theta), 20),
            "library_device_ms": device_ms(lambda: torch.mv(Xb, yb * theta), 20),
            "bytes": x_bytes + 2 * n * 4 + 4 * m * 4, "flops": 7 * m * n,
            "max_abs_err": err(sums, screen.screen_partial_plain(Xb, yb, theta),
                               screen.screen_partial_plain(Xb.abs(), yb.abs(), theta.abs()),
                               n)},
        "sample_surplus": {
            "ms": timed_ms(lambda: screen.sample_partial_op(Xb, w), 20),
            "finalize_ms": timed_ms(lambda: screen.sample_finalize_op(
                pair, yb, 0.13, 0.37, 0.05), 20),
            "plain_ms": timed_ms(lambda: screen.sample_partial_plain(Xb, w), 20),
            "library_ms": timed_ms(lambda: torch.mv(Xb.t(), w), 20),
            "bytes": x_bytes + m * 4 + 2 * n * 4, "flops": 4 * m * n,
            "max_abs_err": err(pair, screen.sample_partial_plain(Xb, w),
                               screen.sample_partial_plain(Xb.abs(), w.abs()), m)},
    }
    for v in out.values():
        t_bytes = v["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = v["flops"] / FP32_FLOPS * 1e3
        v["bound_ms"] = max(t_bytes, t_ops)
        v["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    emit({"phase": "partial_timing", "shape": [m, n], "bitwise_vs_full": bits, **out})
    del Xb
    return out


def bound_of(t) -> tuple:
    """``(bound_ms, bound_by)``: the larger of ``t``'s bytes over the HBM
    rate and its flops over the fp32 rate."""
    t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = t["flops"] / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


#: the device times a timing record may carry beside its per-call ``ms``
#: (:func:`device_ms`): the kernel's, the library call's, and for the feature
#: screen ``torch.mv(X, y theta1)``'s both ways
DEVICE_KEYS = ("device_ms", "library_device_ms", "mv_ms", "mv_device_ms")


def _row(name, replaces, source, t, shape, launches, max_err, step) -> dict:
    """One kernel's entry of the ``kernels`` line: its times, its bound
    (:func:`bound_of`) and its launches in the path that carries it."""
    bound_ms, bound_by = bound_of(t)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": int(launches[name]), "max_abs_err": max_err[name],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": t["library_ms"],
        "shape_rows_cols_valid": shape, "path_step": step,
        **{key: t[key] for key in DEVICE_KEYS if key in t},
    }


def phase_timing(K, res, launches, res_c, launches_c, dyn, rule_launches, X, y,
                 max_err, solver, serve_launches, serve_shapes) -> list:
    """Each kernel, its plain version and the one library call at the shape
    its path gave it, with the least time the card could take. The hinge
    kernels and the feature screen take their shapes and launch counts from
    the feature-rule path (``res``, ``launches``), the sample screen from
    the composite path (``res_c``, ``launches_c``); every row also carries
    its launches in the composite path. The feature screen's dynamic variant
    (``dyn``: the dynamic paths' launch counts) is timed at the full width
    with sample weights and the cap, as the composite dynamic path runs it,
    and one whole refresh beside it. The EDPP mode (``rule_launches``: the
    launch counts of the ``edpp``, ``auto`` and ``sifs`` paths) is timed in
    turns with the VI mode on the same anchor: VI, EDPP, EDPP, VI. Its
    weighted instantiation (``serve_launches``: the path server's launch
    counts) is timed in turns with the weighted VI launch, under a 0/1 mask
    of 9,000 live samples; both are held against their plain versions. Its
    row's own times are those at the EDPP group's padded slot, where the
    server launched it (``serve_shapes``: :meth:`Kernels.serve_slot`'s
    times by group); each row the server launches carries its times at the
    serve's shapes too."""
    hinge, screen = K.hinge, K.screen
    m, n = X.shape
    # the hinge kernels: the step whose solve swept the most rows in total
    k = max(range(1, len(res.lambdas)),
            key=lambda i: int(res.kept[i]) * int(res.solver_iters[i]))
    kept = int(res.kept[k])
    mask = res.extras["keep_masks"][k]
    pad = m if kept == m else min(_bucket(max(kept, 1)), m)
    Xr = torch.zeros((pad, n), dtype=X.dtype, device="cuda")
    Xr[:kept] = X[torch.from_numpy(np.nonzero(mask)[0]).cuda()]
    wr = torch.zeros(pad, device="cuda")
    wr[:kept] = torch.from_numpy(res.weights[k][mask]).float().cuda()
    b = torch.tensor(float(res.biases[k]), device="cuda")
    _, xi, _ = hinge.margin_obj_plain(Xr, wr, y, b, kept)
    v = y * xi
    reps = 50
    x_bytes = kept * n * 4
    margin = {
        "ms": timed_ms(lambda: hinge.margin_obj_op(Xr, wr, y, b, kept), reps),
        "device_ms": device_ms(lambda: hinge.margin_obj_op(Xr, wr, y, b, kept), reps),
        "plain_ms": timed_ms(lambda: hinge.margin_obj_plain(Xr, wr, y, b, kept), reps),
        "library_ms": timed_ms(lambda: torch.mv(Xr[:kept].t(), wr[:kept]), reps),
        "library_device_ms": device_ms(lambda: torch.mv(Xr[:kept].t(), wr[:kept]), reps),
        "bytes": x_bytes + kept * 4 + n * 4 + 4 + 2 * n * 4 + 4,
        "flops": 2 * kept * n + 5 * n,
    }
    grad = {
        "ms": timed_ms(lambda: hinge.hinge_grad_op(Xr, y, xi, kept), reps),
        "device_ms": device_ms(lambda: hinge.hinge_grad_op(Xr, y, xi, kept), reps),
        "plain_ms": timed_ms(lambda: hinge.hinge_grad_plain(Xr, y, xi, kept), reps),
        "library_ms": timed_ms(lambda: torch.mv(Xr[:kept], v), reps),
        "library_device_ms": device_ms(lambda: torch.mv(Xr[:kept], v), reps),
        "bytes": x_bytes + 2 * n * 4 + pad * 4,
        "flops": 2 * kept * n + n,
    }
    # the screen: every step sweeps the full X from the previous anchor
    lam1, lam2 = float(res.lambdas[k - 1]), float(res.lambdas[k])
    theta = (torch.rand(n, device="cuda") / lam1)
    sh = K.shared_scalars(y, lam1, lam2, theta, delta=1e-3)
    e = K.edpp_scalars(y, lam1, lam2, theta, delta=1e-3)

    def vi_mode():
        return screen.screen_bounds_from_shared(X, y, theta, sh)

    def edpp_mode():
        return screen.screen_bounds_edpp(X, y, theta, sh, e)

    turns = [timed_ms(f, 20) for f in (vi_mode, edpp_mode, edpp_mode, vi_mode)]
    packed_vi, packed_e = screen.pack_shared(sh), screen.pack_shared(sh, edpp=e)
    dturns = [device_ms(lambda: screen._launch_features(
        X, y, theta, packed_e if f else packed_vi, None, f,
        "screen_bounds_edpp" if f else "screen_bounds"), 20)
        for f in (False, True, True, False)]
    scr = {
        "ms": 0.5 * (turns[0] + turns[3]),
        "plain_ms": timed_ms(lambda: screen.screen_bounds_plain(X, y, theta, sh), 20),
        **screen_device_times(screen, X, y, theta, packed_vi, None, False,
                              "screen_bounds", 20),
        "bytes": m * n * 4 + 2 * n * 4 + 48 + m * 4,
        "flops": 7 * m * n + n + 60 * m,
    }
    # the one library call reading the same bytes: d_theta only
    scr["library_ms"], scr["library_device_ms"] = scr["mv_ms"], scr["mv_device_ms"]
    scr["device_ms"] = 0.5 * (dturns[0] + dturns[3])
    edpp_t = {
        "ms": 0.5 * (turns[1] + turns[2]),
        "device_ms": 0.5 * (dturns[1] + dturns[2]),
        "plain_ms": timed_ms(lambda: screen.screen_bounds_edpp_plain(X, y, theta, sh, e),
                             20),
        "library_ms": None,
        "bytes": m * n * 4 + 2 * n * 4 + 64 + m * 4,
        "flops": 7 * m * n + n + 80 * m,
    }
    emit({"phase": "screen_modes_in_turns", "shape": [m, n],
          "order": "vi, edpp, edpp, vi", "ms": turns, "device_ms": dturns})
    rows = []
    specs = [
        ("margin_obj", "src/repro/kernels/hinge.py:36 _margin_kernel",
         "src/repro_torch/kernels/csrc/hinge.cu", margin, [pad, n, kept]),
        ("hinge_grad", "src/repro/kernels/hinge.py:109 _grad_kernel",
         "src/repro_torch/kernels/csrc/hinge.cu", grad, [pad, n, kept]),
        ("screen_bounds", "src/repro/kernels/screen.py:142 _feature_kernel",
         "src/repro_torch/kernels/csrc/screen.cu", scr, [m, n, m]),
    ]
    for name, replaces, source, t, shape in specs:
        rows.append(_row(name, replaces, source, t, shape, launches, max_err, k))
    rows.append(_row("screen_bounds_edpp",
                     "src/repro/kernels/screen.py:142 _feature_kernel (EDPP mode: "
                     "src/repro/core/rules/programs.py:126 _edpp_bounds)",
                     "src/repro_torch/kernels/csrc/screen.cu", edpp_t, [m, n, m],
                     rule_launches["edpp"], max_err, k))
    # the sample screen: every composite step sweeps the full X from the
    # previous solution, with the secant history and the trust radii
    T = len(res_c.lambdas)
    w1 = torch.from_numpy(res_c.weights[T - 2]).float().cuda()
    b1 = float(res_c.biases[T - 2])
    u_prev = torch.mv(X.t(), torch.from_numpy(res_c.weights[T - 3]).float().cuda())
    u_prev += float(res_c.biases[T - 3])
    dw = 1.5 * float(np.linalg.norm(res_c.weights[T - 2] - res_c.weights[T - 3]))
    db = 1.5 * abs(float(res_c.biases[T - 2] - res_c.biases[T - 3]))
    args = (X, w1, y, b1, dw, db, u_prev)
    smp = {
        "ms": timed_ms(lambda: screen.sample_surplus_op(*args), 20),
        "plain_ms": timed_ms(lambda: screen.sample_surplus_plain(*args), 20),
        "library_ms": timed_ms(lambda: torch.mv(X.t(), w1), 20),
        "bytes": m * n * 4 + m * 4 + 2 * n * 4 + 48 + 2 * n * 4,
        "flops": 4 * m * n + 12 * n,
    }
    rows.append(_row("sample_surplus", "src/repro/kernels/screen.py:165 _sample_kernel",
                     "src/repro_torch/kernels/csrc/sample.cu", smp, [m, n, m],
                     launches_c, max_err, T - 1))
    # the dynamic variant: every refresh of the full-width dynamic paths reads
    # all of X, with the live-sample weights in mask mode
    lam = float(res_c.lambdas[T - 1])
    s = torch.ones(n, device="cuda")
    s[torch.randperm(n, device="cuda")[: n // 4]] = 0.0
    w_last = torch.from_numpy(res_c.weights[T - 1]).float().cuda()
    b_last = torch.tensor(float(res_c.biases[T - 1]), device="cuda")
    u_last = torch.mv(X.t(), w_last)
    theta_d, delta, _ = solver.gap_theta_delta(X, y, w_last, b_last, lam, s, u=u_last)
    sh_d = K.dynamic_shared(y, lam, theta_d, float(delta), s)
    sh_u = K.dynamic_shared(y, lam, theta_d, float(delta), None)
    packed_d = screen.pack_shared(sh_d, delta)
    dyn_t = {
        "ms": timed_ms(lambda: screen.screen_bounds_from_shared(
            X, y, theta_d, sh_d, s, delta), 20),
        "device_ms": device_ms(lambda: screen._launch_features(
            X, y, theta_d, packed_d, s, False, "screen_bounds_dynamic"), 20),
        "plain_ms": timed_ms(lambda: screen.screen_bounds_plain(
            X, y, theta_d, sh_d, s, delta), 20),
        "library_ms": None,
        "bytes": m * n * 4 + 3 * n * 4 + 48 + m * 4,
        "flops": 8 * m * n + 2 * n + 70 * m,
    }
    dyn_launches = {"screen_bounds_dynamic": dyn["feature"]["screen_bounds_dynamic"]}
    rows.append(_row("screen_bounds_dynamic",
                     "src/repro/kernels/screen.py:142 _feature_kernel (dynamic variant)",
                     "src/repro_torch/kernels/csrc/screen.cu", dyn_t, [m, n, m],
                     dyn_launches, max_err, T - 1))
    # the weighted EDPP mode: a server slot's 0/1 mask of live samples, in
    # turns with the weighted VI launch on the same anchor
    s9 = torch.zeros(n, device="cuda")
    s9[torch.randperm(n, device="cuda")[:SERVE_LIVE]] = 1.0
    theta_w = theta * s9
    sh_w, e_w = K.weighted_scalars(y, lam1, lam2, theta_w, 1e-3, s9)

    def weighted_vi():
        return screen.screen_bounds_from_shared(X, y, theta_w, sh_w, weights=s9)

    def weighted_edpp():
        return screen.screen_bounds_edpp(X, y, theta_w, sh_w, e_w, weights=s9)

    wturns = [timed_ms(f, 20) for f in (weighted_vi, weighted_edpp, weighted_edpp,
                                        weighted_vi)]
    packed_wv, packed_we = screen.pack_shared(sh_w), screen.pack_shared(sh_w, edpp=e_w)
    wdturns = [device_ms(lambda: screen._launch_features(
        X, y, theta_w, packed_we if f else packed_wv, s9, f,
        "screen_bounds_edpp_weighted" if f else "screen_bounds_dynamic"), 20)
        for f in (False, True, True, False)]
    got_e, got_v = weighted_edpp(), weighted_vi()
    plain_e = screen.screen_bounds_edpp_plain(X, y, theta_w, sh_w, e_w, s9)
    torch.cuda.synchronize()
    K._check("screen_bounds_edpp_weighted", got_e, plain_e, n, "timing weighted edpp")
    K._check("screen_bounds_dynamic", got_v,
             screen.screen_bounds_plain(X, y, theta_w, sh_w, s9), n, "timing weighted vi")
    require(bool((got_e <= got_v).all()), "timing: weighted EDPP above weighted VI")
    edpp_w = {
        "ms": 0.5 * (wturns[1] + wturns[2]),
        "device_ms": 0.5 * (wdturns[1] + wdturns[2]),
        "plain_ms": timed_ms(lambda: screen.screen_bounds_edpp_plain(
            X, y, theta_w, sh_w, e_w, s9), 20),
        "library_ms": None,
        "bytes": m * n * 4 + 3 * n * 4 + 64 + m * 4,
        "flops": 8 * m * n + 2 * n + 80 * m,
    }
    emit({"phase": "screen_weighted_modes_in_turns", "shape": [m, n], "live": SERVE_LIVE,
          "order": "weighted vi, weighted edpp, weighted edpp, weighted vi", "ms": wturns,
          "device_ms": wdturns,
          "weighted_vi_plain_ms": timed_ms(lambda: screen.screen_bounds_plain(
              X, y, theta_w, sh_w, s9), 20),
          "below_vi": int((got_e < got_v).sum())})
    at_slot = serve_shapes["edpp"]["timing"]["screen_bounds_edpp_weighted"][0]
    rows.append(_row("screen_bounds_edpp_weighted",
                     "src/repro/kernels/screen.py:142 _feature_kernel (weighted EDPP mode: "
                     "src/repro/core/rules/programs.py:126 _edpp_bounds over the path "
                     "server's sample-masked FixedStats)",
                     "src/repro_torch/kernels/csrc/screen.cu", at_slot, at_slot["shape"],
                     serve_launches, max_err, "serve edpp group, slot 0"))
    rows[-1]["full_width_9000_live"] = {
        "shape": [m, n, m], "ms": edpp_w["ms"], "device_ms": edpp_w["device_ms"],
        "plain_ms": edpp_w["plain_ms"], "bound_ms": bound_of(edpp_w)[0]}
    for row in rows:
        row["at_serve_shapes"] = [
            {"group": label, **{key: t[key] for key in (
                "shape", "step", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                *DEVICE_KEYS) if key in t}}
            for label, got in serve_shapes.items()
            for t in got["timing"].get(row["name"], [])]
    for row in rows:
        row["launches_composite_path"] = int(launches_c[row["name"]])
        row["launches_dynamic_feature_path"] = int(dyn["feature"][row["name"]])
        row["launches_dynamic_composite_path"] = int(dyn["composite"][row["name"]])
        for label, counts in rule_launches.items():
            row[f"launches_{label}_path"] = int(counts[row["name"]])
    # one refresh of the dynamic solver at full width, in its parts: the
    # certificate (5 GEMVs over X from the carried margins), the screen, the
    # margin sweep of a restart
    wm = w_last * (torch.rand(m, device="cuda") < 0.5)
    refresh = {
        "certificate_ms": timed_ms(lambda: solver.gap_theta_delta(
            X, y, w_last, b_last, lam, s, u=u_last), 10),
        "screen_ms": timed_ms(lambda: solver.refresh_bounds(
            X, y, lam, theta_d, delta, s), 10),
        "restart_margin_ms": timed_ms(lambda: hinge.margin_obj_op(X, wm, y, b_last), 10),
    }
    refresh["total_ms"] = sum(refresh.values())
    emit({"phase": "refresh_timing", "shape": [m, n], "lam": lam, **refresh})
    sms = hinge.sm_count(X.device)
    gp = hinge.grad_plan(kept, n, Xr.element_size(), hinge.bulk_aligned(Xr), sms)
    mp = hinge.column_sweep_plan(kept, n, Xr.element_size(), hinge.bulk_aligned(Xr), sms)
    cp = hinge.column_sweep_plan(m, n, X.element_size(), hinge.bulk_aligned(X), sms)
    sp = screen.screen_plan(m, n, X.element_size(), hinge.bulk_aligned(X), sms)
    emit({"phase": "plans", "sms": sms,
          "margin_obj": {**mp._asdict(), "tiles": mp.tiles, "smem_bytes": mp.smem_bytes},
          "hinge_grad": {**gp._asdict(), "smem_bytes": gp.smem_bytes},
          "sample_surplus": {**cp._asdict(), "tiles": cp.tiles,
                             "smem_bytes": cp.smem_bytes},
          "screen_bounds": {**sp._asdict(), "segs": sp.segs, "tiles": sp.tiles,
                            "smem_bytes": sp.smem_bytes}})
    emit({"phase": "timing", "step": k, "kept": kept, "bucket": pad,
          "rows": [{key: r[key] for key in ("name", "ms", "plain_ms", "library_ms",
                                             "bound_ms")} for r in rows],
          "dynamic_unweighted_ms": timed_ms(lambda: screen.screen_bounds_from_shared(
              X, y, theta_d, sh_u, None, delta), 20)})
    # the hinge kernels at the full width too (the unscreened solve's shape)
    w = torch.randn(m, device="cuda") * 0.01
    _, xi_f, _ = hinge.margin_obj_plain(X, w, y, b)
    vf = y * xi_f
    emit({"phase": "timing_full_width", "shape": [m, n],
          "bound_ms": m * n * 4 / HBM_BYTES_PER_S * 1e3,
          "margin_ms": timed_ms(lambda: hinge.margin_obj_op(X, w, y, b), 20),
          "margin_plain_ms": timed_ms(lambda: hinge.margin_obj_plain(X, w, y, b), 20),
          "margin_library_ms_u_only": timed_ms(lambda: torch.mv(X.t(), w), 20),
          "grad_ms": timed_ms(lambda: hinge.hinge_grad_op(X, y, xi_f), 20),
          "grad_plain_ms": timed_ms(lambda: hinge.hinge_grad_plain(X, y, xi_f), 20),
          "grad_library_ms": timed_ms(lambda: torch.mv(X, vf), 20)})
    return rows


# ---------------------------------------------------------------------------
# the LM scaffold's serving path (repro_torch.models, launch/serve.py): plain
# PyTorch products and softmaxes, no kernel of this repository on its path
# ---------------------------------------------------------------------------

LM_DENSE = ("qwen2.5-3b", "granite-8b", "internlm2-20b", "stablelm-12b")
LM_FAMILIES = ("mamba2-130m", "deepseek-v2-236b", "arctic-480b", "internvl2-26b",
               "whisper-base", "recurrentgemma-9b")
# lm_families_card_vs_cpu's prompt (20 tokens for the others): 96 crosses
# chunks, 3 of the SMOKE SSD's 32 (the state carried from chunk to chunk)
# and 1.5 of the RG-LRU scan's 64 (and recurrentgemma's 16-slot window)
LM_FAMILY_PROMPT = {"mamba2-130m": 96, "recurrentgemma-9b": 96}
LM_F32_REL = 1e-5        # card vs CPU, float32 with TF32 off: one model's float32
                         # steps summed in other orders (max |d| / max |ref|)
# the same, each device decoding from its own prefill's bf16 cache (see
# lm_card_vs_cpu): 2.1e-5 the largest dense reading (stablelm-12b), 5x that
LM_OWN_CACHE_REL = 1e-4
LM_CARD_DEPTH = 2        # lm_card_vs_cpu's full-width qwen2.5-3b: 2 of its 36 layers
LM_CARD_PROMPT = 32
LM_WHISPER = dict(B=2, S=64, T=4)  # whisper-base whole, card vs CPU
LM_SLOTS, LM_REQUESTS, LM_NEW = 4, 8, 32
LM_PREFILL_LENS = (64, 256, 1024)
LM_CHECKED = 2           # requests whose every decode step meets a teacher-forced prefill
LM_ALONE = (0, 4)        # requests served again alone (4 waited for a slot)
LM_TF_CAPACITY = 8.0     # an MoE's teacher-forced checks: no prefill drops a token
# bf16 decode against a bf16 teacher-forced prefill of the same tokens: the
# two run other GEMM shapes (4 rows against the prompt's), so every product
# may round to the other bf16 neighbour (2**-8) in each layer; the CPU tests
# measure 5e-3 to 1.1e-2 across 2 layers against the reference.
LM_BF16_REL = 5e-2
# decode steps whose token a near tie routed to other experts than its
# teacher-forced prefill did (deepseek-v2-236b: 3 of 62 measured, each
# within 0.070): at most 3x that many, each within 3x that
LM_ROUTE_FLIPS_MAX = 9
LM_FLIP_REL = 0.2
LM_SEED = 0
SSM_PROMPTS = (64, 128, 256, 512, 768, 1024)  # lengths below chunk 256 or multiples of it


class ServeCell:
    """One ``phase_lm_serve`` run: an architecture's published widths, its
    depth (``layers``, 0 for the published one), the server's positions, how
    each request's prompt length is drawn, ``(rng, i) -> int``."""

    def __init__(self, phase, arch, prompt_len, layers=0, max_seq=2048):
        self.phase, self.arch, self.prompt_len = phase, arch, prompt_len
        self.layers, self.max_seq = layers, max_seq

    def config(self, configs):
        cfg = configs.get_config(self.arch)
        return cfg.replace(num_layers=self.layers) if self.layers else cfg


LM_CELLS = (
    # qwen2.5-3b at full width and depth: prompts of 64 to 1,024 tokens
    ServeCell("lm_serve", "qwen2.5-3b", lambda rng, i: rng.integers(64, 1025)),
    # deepseek-v2-236b's widths (MLA, 160 experts top-6, 2 shared) on 2 of 60 layers
    ServeCell("lm_serve_moe", "deepseek-v2-236b", lambda rng, i: rng.integers(64, 1025),
              layers=2),
    # mamba2-130m whole: each of the six lengths, then 64 and 128 (the SSD takes a
    # prompt below its chunk or a multiple of it)
    ServeCell("lm_serve_ssm", "mamba2-130m", lambda rng, i: SSM_PROMPTS[i % len(SSM_PROMPTS)]),
    # recurrentgemma-9b's widths on 5 of 38 layers, one (rec, rec, attn) unit
    # and the (rec, rec) remainder; request 1's prompt passes the 2,048 window
    ServeCell("lm_serve_hybrid", "recurrentgemma-9b",
              lambda rng, i: 2560 if i == 1 else rng.integers(64, 1025), layers=5,
              max_seq=4096),
)


def lm_bytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def lm_leaves(tree) -> list:
    """``(path, tensor)`` of every leaf of a parameter or cache tree, the
    path the tuple of ``tree.tree_keys``'s key."""
    from repro_torch.tree import tree_keys

    return [(tuple(key.split("/")), t) for key, t in tree_keys(tree).items()]


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float64 on the host."""
    a = got.detach().double().cpu()
    b = want.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def lm_requests(serve, cfg, n, new, prompt_len, seed) -> list:
    """The serve launcher's requests: each prompt's length drawn, then its
    tokens, from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [serve.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                     int(prompt_len(rng, i))).astype(np.int32),
                          max_new=new) for i in range(n)]


def lm_extras(cfg, B, seed) -> dict:
    """A batch's inputs besides its tokens, on the host, as the reference's
    tests make them: an enc-dec model's frame embeddings, a VLM's prefix
    embeddings (0.1 x a standard normal)."""
    rng = np.random.default_rng(seed)
    shape = {"encdec": ("enc_embeds", cfg.enc_seq),
             "vlm": ("prefix_embeds", cfg.num_prefix_tokens)}.get(cfg.family)
    if shape is None:
        return {}
    return {shape[0]: torch.from_numpy(
        (0.1 * rng.standard_normal((B, shape[1], cfg.d_model))).astype(np.float32))}


def bf16_flips(got, want) -> tuple:
    """``(elements that differ, all explained by rounding)`` of two bf16
    caches whose float32 sources agree within ``LM_F32_REL`` of their
    scale: a value may round to the other bf16 neighbour, so each element
    may differ by its own bf16 ulp plus that float32 difference (a sum that
    cancels to near 0 differs by more than its own ulp)."""
    a, b = got.float().cpu(), want.float().cpu()
    diff = (a - b).abs()
    ulp = torch.ldexp(torch.ones_like(a), torch.frexp(torch.maximum(a.abs(), b.abs()))[1] - 8)
    return int((diff > 0).sum()), bool((diff <= ulp + LM_F32_REL * b.abs().max()).all())


def cache_card_vs_cpu(on_card, cpu, where) -> int:
    """Two caches leaf by leaf, each leaf in one dtype on both devices: a
    bf16 leaf equal but for values rounded to the other neighbour
    (:func:`bf16_flips`), a float32 leaf (the ssm and rec states, a float32
    model's promoted K/V) within ``LM_F32_REL``. Returns the bf16 flips."""
    want = dict(lm_leaves(cpu))
    flips = 0
    for path, t in lm_leaves(on_card):
        require(t.dtype == want[path].dtype, f"{where}: cache leaf {path} {t.dtype}")
        if t.dtype == torch.bfloat16:
            n, ok = bf16_flips(t, want[path])
            require(ok, f"{where}: cache leaf {path} off by more than a bf16 rounding "
                        "of float32 values within LM_F32_REL")
            flips += n
        else:
            err = rel_err(t, want[path])
            require(err <= LM_F32_REL, f"{where}: cache leaf {path} card vs CPU rel {err}")
    return flips


def lm_card_vs_cpu(tr, serve, cfg, cpu, seed, B, S, T, serve_check=True) -> dict:
    """One float32 model, the same weights on the card and the CPU: the
    prefill logits (within ``LM_F32_REL``) and every cache leaf it leaves
    (:func:`cache_card_vs_cpu`); T decode steps, each on the card from the
    CPU's cache of that step (logits within ``LM_F32_REL``, the caches after
    the last step leaf by leaf) and along each device's own caches (within
    ``LM_OWN_CACHE_REL``: one K/V value rounded to the other bf16 neighbour
    in the prefill moves a float32 model's logits by ~1e-5 of their scale);
    then a ``BatchedServer``'s greedy tokens (6 requests on 3 slots)."""
    from repro_torch.tree import tree_map

    on_card = tree_map(lambda t: t.cuda(), cpu)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                                 (B, S + T)))
    extras = lm_extras(cfg, B, seed)
    (lc, cache_c), (lg, own) = [
        tr.prefill(p, cfg, {"tokens": toks[:, :S].to(d),
                            **{k: v.to(d) for k, v in extras.items()}}, max_seq=S + T + 4)
        for p, d in ((cpu, "cpu"), (on_card, "cuda"))]
    errs = {"prefill": rel_err(lg, lc), "decode_same_cache": [], "decode_own_cache": []}
    flips = cache_card_vs_cpu(own, cache_c, f"lm {cfg.name} prefill")
    for t in range(T):
        tok, pos = toks[:, S + t:S + t + 1], torch.full((B,), S + t)
        same = tree_map(lambda x: x.cuda(), cache_c)   # decode writes its cache in place
        lc, cache_c = tr.decode_step(cpu, cfg, tok, pos, cache_c)
        lg, same = tr.decode_step(on_card, cfg, tok.cuda(), pos.cuda(), same)
        errs["decode_same_cache"].append(rel_err(lg, lc))
        lg, own = tr.decode_step(on_card, cfg, tok.cuda(), pos.cuda(), own)
        errs["decode_own_cache"].append(rel_err(lg, lc))
    decode_flips = cache_card_vs_cpu(same, cache_c, f"lm {cfg.name} decode")
    require(max(errs["prefill"], *errs["decode_same_cache"]) <= LM_F32_REL,
            f"lm {cfg.name}: card vs CPU {errs}")
    require(max(errs["decode_own_cache"]) <= LM_OWN_CACHE_REL,
            f"lm {cfg.name}: card vs CPU from their own caches {errs}")
    report = {**errs, "prefill_cache_bf16_flips": flips,
              "decode_cache_bf16_flips": decode_flips}
    if serve_check:
        tokens = []
        for p, d in ((cpu, "cpu"), (on_card, "cuda")):
            reqs = lm_requests(serve, cfg, 6, 8, lambda rng, i: rng.integers(4, 24), seed)
            serve.BatchedServer(cfg, p, batch_slots=3, max_seq=128, device=d).serve(
                reqs, log=_quiet)
            tokens.append([r.out for r in reqs])
        require(tokens[0] == tokens[1], f"lm {cfg.name}: the card's greedy tokens differ")
        report["served_tokens_equal"] = True
    return report


def phase_lm_card_vs_cpu(configs, tr, serve) -> None:
    """The four dense archs' SMOKE configs in float32 (:func:`lm_card_vs_cpu`),
    then qwen2.5-3b at full width on 2 layers: a 32-token prompt's logits."""
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    report = {}
    for i, arch in enumerate(LM_DENSE):
        cfg = configs.get_smoke_config(arch).replace(dtype="float32")
        cpu = tr.init_params(cfg, torch.Generator().manual_seed(10 + i), "cpu")
        report[arch] = lm_card_vs_cpu(tr, serve, cfg, cpu, 10 + i, B=2, S=20, T=4)
    cfg = configs.get_config("qwen2.5-3b").replace(num_layers=LM_CARD_DEPTH, dtype="float32")
    on_card = tr.init_params(cfg, torch.Generator(device="cuda").manual_seed(20), "cuda")
    cpu = tree_map(lambda t: t.cpu(), on_card)
    toks = torch.from_numpy(np.random.default_rng(20).integers(
        0, cfg.vocab_size, (1, LM_CARD_PROMPT)))
    lg, _ = tr.prefill(on_card, cfg, {"tokens": toks.cuda()})
    lc, _ = tr.prefill(cpu, cfg, {"tokens": toks})
    err = rel_err(lg, lc)
    require(bool(torch.isfinite(lg).all()) and err <= LM_F32_REL,
            f"lm full width: card vs CPU rel {err}")
    report["full_width"] = {"arch": cfg.name, "layers": LM_CARD_DEPTH, "d_model": cfg.d_model,
                            "vocab": cfg.padded_vocab, "prompt": LM_CARD_PROMPT,
                            "param_bytes": lm_bytes(on_card), "prefill_rel": err}
    del on_card, cpu
    torch.cuda.empty_cache()
    emit({"phase": "lm_card_vs_cpu", "tolerance_rel": LM_F32_REL,
          "tolerance_own_cache_rel": LM_OWN_CACHE_REL, **report,
          "seconds": time.perf_counter() - t0})


def phase_lm_families_card_vs_cpu(configs, tr, serve) -> None:
    """The six other families' SMOKE configs in float32 as the dense ones
    (:func:`lm_card_vs_cpu`; the SSM and the hybrid on prompts that cross
    their scans' chunks, :data:`LM_FAMILY_PROMPT`; enc-dec with its frame embeddings and without
    the server, which refuses it; the VLM with prefix embeddings), then
    whisper-base whole (6 + 6 layers, d_model 512, 1,500 encoder frames) in
    float32: B = 2, a 64-token prompt, 4 decode steps, card vs CPU."""
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    report = {}
    for i, arch in enumerate(LM_FAMILIES):
        cfg = configs.get_smoke_config(arch).replace(dtype="float32")
        cpu = tr.init_params(cfg, torch.Generator().manual_seed(30 + i), "cpu")
        S = LM_FAMILY_PROMPT.get(arch, 20)
        report[arch] = {"prompt": S, **lm_card_vs_cpu(tr, serve, cfg, cpu, 30 + i, B=2, S=S, T=4,
                                                      serve_check=cfg.family != "encdec")}
    cfg = configs.get_config("whisper-base").replace(dtype="float32")
    on_card = tr.init_params(cfg, torch.Generator(device="cuda").manual_seed(40), "cuda")
    cpu = tree_map(lambda t: t.cpu(), on_card)
    t1 = time.perf_counter()
    report["whisper_full"] = {
        "layers": cfg.num_layers, "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
        "enc_seq": cfg.enc_seq, "vocab": cfg.padded_vocab, **LM_WHISPER,
        **lm_card_vs_cpu(tr, serve, cfg, cpu, 40, **LM_WHISPER, serve_check=False),
        "param_bytes": lm_bytes(on_card), "seconds": time.perf_counter() - t1}
    del on_card, cpu
    torch.cuda.empty_cache()
    emit({"phase": "lm_families_card_vs_cpu", "tolerance_rel": LM_F32_REL,
          "tolerance_own_cache_rel": LM_OWN_CACHE_REL, **report,
          "seconds": time.perf_counter() - t0})


def lm_work(cfg, weights, cache) -> dict:
    """What a serving copy of the weights and its cache cost, for the bounds:

    * ``dense_bytes``: every weight but the embedding table (a row a token)
      and the routed experts, the head included (the table itself when
      tied); ``expert_bytes``: one routed expert of one layer;
    * ``params_token``: the entries of the products one token applies (the
      layers' products, k routed experts a layer), ``head``: the head's;
    * ``pos_bytes``: one slot's position of the K/V or latent leaves, all
      layers; ``state_bytes``: one slot's conv tails and ssm/rec states;
    * ``pair_prefill``, ``pair_decode``: float32 operations of one (query,
      key) pair over every attention layer (the port's scores and PV are
      float32; MLA's absorbed decode scores against the latent);
      ``ssd_layers`` and ``ssd`` (heads, head dim, state) for the SSD's
      float32 contractions.
    """
    from repro_torch.models.transformer import PRODUCT_LEAVES

    E, k = cfg.moe_num_experts, cfg.moe_top_k
    head = weights["head"] if "head" in weights else weights["embed"]["tok"]
    dense_bytes = head.numel() * head.element_size()
    params_token = expert_bytes = expert_params = 0
    for path, t in lm_leaves(weights):
        if path[0] in ("embed", "head"):
            continue
        if len(path) >= 2 and path[-2] == "moe" and path[-1] in ("wi", "wg", "wo"):
            n_experts = t.shape[0] * t.shape[1]              # units x E
            expert_bytes += t.numel() * t.element_size() // n_experts
            expert_params += t.numel()
            continue
        dense_bytes += t.numel() * t.element_size()
        if path[-1] in PRODUCT_LEAVES:
            params_token += t.numel()
    if E:
        params_token += expert_params * k // E
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    L, R = cfg.mla_kv_lora, cfg.mla_rope_dim
    kinds = []  # each layer's kind, from the cache's slots
    for seg in cache["segments"]:
        for slot in seg.values():
            kind = ("attn" if "k" in slot else "mla" if "c" in slot
                    else "ssm" if "state" in slot else "rec")
            kinds += [kind] * next(iter(slot.values())).shape[0]
    pair_prefill = kinds.count("attn") * 4 * H * hd + kinds.count("mla") * 2 * H * (2 * hd + R)
    pair_decode = kinds.count("attn") * 4 * H * hd + kinds.count("mla") * 2 * H * (2 * L + R)
    pos_bytes = sum(t[:, 0, 0].numel() * t.element_size() for path, t in lm_leaves(cache)
                    if path[-1] in ("k", "v", "c", "r"))
    state_bytes = sum(t[:, 0].numel() * t.element_size() for path, t in lm_leaves(cache)
                      if path[-1] in ("conv", "state", "h"))
    d_in = cfg.ssm_expand * cfg.d_model
    nh, P, N = d_in // cfg.ssm_head_dim if cfg.ssm_state else 0, cfg.ssm_head_dim, cfg.ssm_state
    return {"dense_bytes": dense_bytes, "expert_bytes": expert_bytes,
            "params_token": params_token, "head": head.numel(),
            "row_bytes": cfg.d_model * weights["embed"]["tok"].element_size(),
            "pos_bytes": pos_bytes, "state_bytes": state_bytes,
            "pair_prefill": pair_prefill, "pair_decode": pair_decode,
            "ssd_layers": kinds.count("ssm"), "ssd": (nh, P, N)}


def lm_bound(bf16_flops: float, f32_flops: float, nbytes: float) -> tuple:
    """``(bound_ms, bound_by)``: the larger of ``nbytes`` over the HBM rate
    and the operations, the products' at the bf16 tensor-core rate plus the
    float32 contractions' (attention scores and PV, the SSD; TF32 is off)
    at the float32 rate. Elementwise work is not counted."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (bf16_flops / BF16_FLOPS + f32_flops / FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lm_step_bound(cfg, w, live, experts) -> tuple:
    """The decode step's bound at B = len(live) slots reading ``live``
    positions each, ``experts`` routed experts read over its MoE layers."""
    B = len(live)
    nbytes = (w["dense_bytes"] + experts * w["expert_bytes"] + B * w["row_bytes"]
              + w["pos_bytes"] * (sum(live) + B) + 2 * B * w["state_bytes"])
    nh, P, N = w["ssd"]
    f32 = w["pair_decode"] * sum(live) + B * w["ssd_layers"] * 4 * nh * P * N
    return lm_bound(2 * B * (w["params_token"] + w["head"]), f32, nbytes)


def lm_prefill_bound(cfg, w, n, written, experts) -> tuple:
    """A prefill of n tokens at batch 1: ``written`` positions of the cache
    (the window's or ``max_seq``'s), ``experts`` routed experts read."""
    W = cfg.attn_window or n
    pairs = sum(min(t + 1, W) for t in range(n))
    nh, P, N = w["ssd"]
    Q = min(cfg.ssm_chunk, n)
    f32 = w["pair_prefill"] * pairs + n * w["ssd_layers"] * (2 * Q * (N + nh * P) + 4 * nh * P * N)
    nbytes = (w["dense_bytes"] + experts * w["expert_bytes"] + n * w["row_bytes"]
              + written * w["pos_bytes"] + w["state_bytes"])
    return lm_bound(2 * n * w["params_token"] + 2 * w["head"], f32, nbytes)


def near_tie(la, lb, x, y) -> bool:
    """Whether expert ``x``, taken by the run with router logits ``la``, and
    ``y``, taken instead by the run with ``lb``, are a near tie: each run's
    winner leads by at most 2**-7 of the largest of the four logits. The
    router product rounds to bf16 (2**-9 of a logit), and two runs' GEMMs
    sum in other orders."""
    margin = 2.0 ** -7 * float(torch.stack([la[x], la[y], lb[x], lb[y]]).abs().max())
    return float(la[x] - la[y]) <= margin and float(lb[y] - lb[x]) <= margin


def route_flip(dec_calls, tf_calls, slot):
    """The MoE layers where a decode step's token (``slot`` of each decode
    call) and its teacher-forced prefill's last token route to other
    experts, or None if there is none: for each such layer, and each expert
    the decode took alone, the ones the prefill took instead, with both
    runs' router logits and probabilities; in every such layer each
    decode-only expert must have a partner that is a near tie with it
    (:func:`near_tie`)."""
    layers = []
    for layer, (dc, pc) in enumerate(zip(dec_calls, tf_calls)):
        a, b = set(dc["top_i"][slot, 0].tolist()), set(pc["top_i"][-1, -1].tolist())
        if a == b:
            continue
        ld, lp = dc["logits"][slot, 0], pc["logits"][-1, -1]
        pd, pp = torch.softmax(ld, -1), torch.softmax(lp, -1)
        swaps, tie = [], True
        for x in sorted(a - b):
            pairs = []
            for y in sorted(b - a):
                pairs.append({"decode_expert": x, "prefill_expert": y,
                              "decode_logits": [float(ld[x]), float(ld[y])],
                              "prefill_logits": [float(lp[x]), float(lp[y])],
                              "decode_probs": [float(pd[x]), float(pd[y])],
                              "prefill_probs": [float(pp[x]), float(pp[y])],
                              "near_tie": near_tie(ld, lp, x, y)})
            tie = tie and any(q["near_tie"] for q in pairs)
            swaps += pairs
        layers.append({"layer": layer, "swaps": swaps, "near_tie": tie})
    if not layers:
        return None
    return {"layers": layers, "near_tie": all(x["near_tie"] for x in layers)}


def tf_lengths_ok(cfg, req) -> bool:
    """Every teacher-forced prefill of ``req`` (its prompt plus 1 to 31
    tokens) runs: an SSD takes a length below its chunk or a multiple of it."""
    if cfg.family != "ssm":
        return True
    return all(n < cfg.ssm_chunk or n % cfg.ssm_chunk == 0
               for n in range(len(req.prompt) + 1, len(req.prompt) + LM_NEW))


def phase_lm_serve(configs, tr, serve, cell) -> dict:
    """``cell``'s configuration at its published widths (and depth, or the
    cut one), bf16 compute over float32 masters drawn from a seeded
    generator on the card: ``BatchedServer(batch_slots=4)`` serves 8
    requests, 32 new tokens each. Checks: every logit finite; each decode
    step of two requests against a teacher-forced prefill of the prompt plus
    the tokens generated so far (an MoE at capacity factor 8.0, in a second
    serve of those two requests on the same weights, so that no prefill
    drops a token), and two requests' first decode against the same request
    served alone (within ``LM_BF16_REL``). Times the prefill at 64, 256 and
    1,024 tokens and the decode step at B = 4 (CUDA events over back-to-back
    calls: the host's work and launches are in the wall, as the card waits
    on them) beside their bounds, the whole serve's tokens/s, an MoE's
    routed experts read and (token, choice) pairs dropped, and profiles
    three decode steps (the card's busy share)."""
    from repro_torch.testing.lm import RouteRecorder, StepRecorder

    cfg = cell.config(configs)
    gc.collect()  # a StepRecorder and its server refer to each other: collect the last phase's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    masters = tr.init_params(cfg, torch.Generator(device="cuda").manual_seed(LM_SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = lm_bytes(masters)
    server = serve.BatchedServer(cfg, masters, batch_slots=LM_SLOTS, max_seq=cell.max_seq,
                                 device="cuda")
    del masters  # the server holds its compute-dtype copy
    weights = server.params

    reqs = lm_requests(serve, cfg, LM_REQUESTS, LM_NEW, cell.prompt_len, seed=0)
    server.serve([serve.Request(rid=-1, prompt=reqs[0].prompt[:64], max_new=2)],
                 log=_quiet)  # warm-up: the libraries' handles and workspaces
    rec = StepRecorder(server)
    with RouteRecorder() as routes:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        server.serve(reqs, log=_quiet)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t1
    n_steps = len(rec.steps)
    n_tokens = sum(len(r.out) for r in reqs)
    require(all(len(r.out) == LM_NEW for r in reqs), f"{cell.phase}: a request stopped early")
    finite = all(bool(torch.isfinite(lg).all()) for lg, _ in rec.steps) and \
        all(bool(torch.isfinite(lg).all()) for lg in rec.prefills)
    require(finite, f"{cell.phase}: a non-finite logit")

    checked = [r.rid for r in reqs if tf_lengths_ok(cfg, r)][:LM_CHECKED]
    require(len(checked) == LM_CHECKED, f"{cell.phase}: checked requests {checked}")
    tf_cfg = cfg.replace(moe_capacity_factor=LM_TF_CAPACITY) if cfg.moe_num_experts else cfg
    tf_rec, tf_reqs, dec_calls = rec, {rid: reqs[rid] for rid in checked}, []
    if tf_cfg is not cfg:
        tf_server = serve.BatchedServer(tf_cfg, weights, batch_slots=LM_SLOTS,
                                        max_seq=cell.max_seq, device="cuda")
        tf_rec = StepRecorder(tf_server)
        tf_reqs = {rid: serve.Request(rid=rid, prompt=reqs[rid].prompt, max_new=LM_NEW)
                   for rid in checked}
        with RouteRecorder(keep=True) as tf_routes:
            tf_server.serve(list(tf_reqs.values()), log=_quiet)
        dec_calls = [c for c in tf_routes.calls if c["group"] == 1]
        del tf_server
    n_moe = len(dec_calls) // len(tf_rec.steps)   # MoE calls a decode step
    worst, agree, n_checked, flips = 0.0, 0, 0, []
    for si, (logits, live) in enumerate(tf_rec.steps):
        for s, entry in enumerate(live):
            if entry is None or entry[0] not in tf_reqs:
                continue
            rid, k = entry
            toks = np.concatenate([tf_reqs[rid].prompt, np.asarray(tf_reqs[rid].out[:k],
                                                                  np.int32)])
            with RouteRecorder(keep=True) as tf_routes:
                tf, _ = tr.prefill(weights, tf_cfg,
                                   {"tokens": torch.from_numpy(toks[None]).cuda()},
                                   max_seq=cell.max_seq)
            err = rel_err(logits[s], tf[0])
            flip = route_flip(dec_calls[si * n_moe:(si + 1) * n_moe], tf_routes.calls, s)
            if flip is None:
                worst = max(worst, err)
            else:  # the token's route moved on a near tie: named, held to LM_FLIP_REL
                flips.append({"rid": rid, "position": len(toks) - 1, "rel": err, **flip})
            agree += int(torch.argmax(logits[s]) == torch.argmax(tf[0]))
            n_checked += 1
    require(n_checked == LM_CHECKED * (LM_NEW - 1),
            f"{cell.phase}: {n_checked} decode steps checked")
    require(worst <= LM_BF16_REL,
            f"{cell.phase}: decode vs teacher-forced prefill rel {worst}")
    require(all(f["near_tie"] and f["rel"] <= LM_FLIP_REL for f in flips)
            and len(flips) <= LM_ROUTE_FLIPS_MAX,
            f"{cell.phase}: route flips that are not near ties, too far or too many: {flips}")

    alone = {}
    for rid in LM_ALONE:
        single = serve.BatchedServer(cfg, weights, batch_slots=LM_SLOTS, max_seq=cell.max_seq,
                                     device="cuda")
        rec1 = StepRecorder(single)
        single.serve([serve.Request(rid=rid, prompt=reqs[rid].prompt, max_new=2)], log=_quiet)
        a, b = dict(rec.decodes(rid))[1], dict(rec1.decodes(rid))[1]
        alone[rid] = {"rel": rel_err(a, b), "bitwise": bool(torch.equal(a, b))}
        require(alone[rid]["rel"] <= LM_BF16_REL,
                f"{cell.phase}: request {rid} alone {alone[rid]}")
        del single

    w = lm_work(cfg, weights, server.cache)
    rng = np.random.default_rng(1)
    prefill_ms, prefill_bound, prefill_experts = {}, {}, {}
    for n in LM_PREFILL_LENS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).cuda()
        with RouteRecorder() as r_pre:
            tr.prefill(weights, cfg, {"tokens": toks}, max_seq=cell.max_seq)
        prefill_experts[n] = sum(c["experts"] for c in r_pre.calls)
        prefill_ms[n] = timed_ms(lambda: tr.prefill(weights, cfg, {"tokens": toks},
                                                    max_seq=cell.max_seq), 5)
        written = min(n, cfg.attn_window or cell.max_seq)
        prefill_bound[n] = lm_prefill_bound(cfg, w, n, written, prefill_experts[n])
    toks = torch.from_numpy(server.last_tok[:, None].astype(np.int64)).cuda()
    pos = torch.from_numpy(server.positions.astype(np.int64)).cuda()

    def decode():  # the server's step, without the recorder's copies
        rec.step_fn(server.params, server.cache, toks, pos)
    with RouteRecorder() as r_step:
        decode()
    step_experts = sum(c["experts"] for c in r_step.calls)
    step_ms = timed_ms(decode, 20)
    with tempfile.TemporaryDirectory() as tmp:
        trace = f"{tmp}/decode.json"
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("path"):
                for _ in range(3):
                    decode()
                torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        share, names, _ = busy_share(trace)
        n_kernels = sum(1 for e in json.loads(Path(trace).read_text())["traceEvents"]
                        if e.get("cat") == "kernel")

    ring = max((t.shape[2] for p, t in lm_leaves(server.cache) if p[-1] in ("k", "c")),
               default=0)
    live = [min(int(p) + 1, ring) for p in server.positions]
    step_bound_ms, step_bound_by = lm_step_bound(cfg, w, live, step_experts)
    decode_calls = [c for c in routes.calls if c["group"] == 1]
    out = {
        "phase": cell.phase, "arch": cfg.name, "family": cfg.family,
        "layers": cfg.num_layers, "reduced": (
            {"num_layers": [configs.get_config(cell.arch).num_layers, cfg.num_layers]}
            if cell.layers else {}),
        "d_model": cfg.d_model, "vocab": cfg.padded_vocab, "dtype": cfg.dtype,
        "param_dtype": cfg.param_dtype, "param_bytes": param_bytes,
        "param_count": param_bytes // 4, "serving_weight_bytes": lm_bytes(weights),
        "init_s": init_s, "slots": LM_SLOTS, "max_seq": cell.max_seq,
        "requests": LM_REQUESTS, "new_tokens": LM_NEW,
        "prompt_lens": [len(r.prompt) for r in reqs],
        "serve_s": serve_s, "tokens": n_tokens, "tokens_per_s": n_tokens / serve_s,
        "decode_steps": n_steps,
        "decode_step_ms_b4": step_ms, "decode_step_bound_ms": step_bound_ms,
        "decode_step_bound_by": step_bound_by, "decode_step_live_positions": live,
        "cache_bytes": lm_bytes(server.cache),
        "prefill_ms": {str(n): v for n, v in prefill_ms.items()},
        "prefill_bound_ms": {str(n): b[0] for n, b in prefill_bound.items()},
        "prefill_bound_by": {str(n): b[1] for n, b in prefill_bound.items()},
        "teacher_forced_requests": checked, "teacher_forced_rel_max": worst,
        "teacher_forced_steps": n_checked, "teacher_forced_argmax_equal": agree,
        "teacher_forced_route_flips": flips, "route_flips_max": LM_ROUTE_FLIPS_MAX,
        "tolerance_route_flip_rel": LM_FLIP_REL,
        "teacher_forced_capacity_factor": tf_cfg.moe_capacity_factor if cfg.moe_num_experts
        else None, "tolerance_rel": LM_BF16_REL,
        "alone_first_decode": {str(k): v for k, v in alone.items()},
        "decode_profile": {"busy_share": share, "kernels_a_step": n_kernels / 3,
                           "kernel_names": len(names)},
        "peak_gbytes": torch.cuda.max_memory_allocated() / 1e9,
    }
    if cfg.moe_num_experts:
        prefill_calls = [c for c in routes.calls if c["group"] > 1]
        out["moe"] = {
            "experts": cfg.moe_num_experts, "top_k": cfg.moe_top_k,
            "capacity_factor": cfg.moe_capacity_factor,
            "expert_bytes": w["expert_bytes"],
            "decode_experts_read_a_step": sum(c["experts"] for c in decode_calls) / n_steps,
            "decode_experts_read_max_layer": max(c["experts"] for c in decode_calls),
            "timed_step_experts_read": step_experts,
            "prefill_experts_read": {str(n): v for n, v in prefill_experts.items()},
            "serve_prefill_pairs": sum(c["kept"] + c["dropped"] for c in prefill_calls),
            "serve_prefill_pairs_dropped": sum(c["dropped"] for c in prefill_calls),
            "serve_decode_pairs_dropped": sum(c["dropped"] for c in decode_calls)}
    emit(out)
    del server, weights, rec, rec1, tf_rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the LM training path (repro_torch.launch.steps and .train, models' train
# mode, optim/): plain PyTorch and autograd, no kernel of this repository on
# it; the sparse probe then runs the paper's path on its features, through
# the feature-screen, margin and gradient kernels
# ---------------------------------------------------------------------------

#: lm_train_card_vs_cpu's sequence (32 tokens for the others): 64 crosses the
#: SMOKE SSD's chunk of 32, 96 the RG-LRU scan's 64 and the 16-slot window
LM_TRAIN_SEQ = {"mamba2-130m": 64, "recurrentgemma-9b": 96}
LM_TRAIN_STEPS = 3       # steps after the first, card against CPU
# card vs CPU, float32 with TF32 off, about 3x the largest reading (chip_smoke,
# NVIDIA H100 80GB HBM3): the loss, ce, aux and grad norm of the first step and
# the next 3 steps' losses (1.6e-7); both moments after the first update, of
# each leaf's scale (1.9e-5, mamba2-130m's; the others' 3.3e-6 at most); the
# parameters after it, the card's AdamW fed the CPU's gradients (9.7e-8)
LM_TRAIN_LOSS_REL = 5e-7
LM_TRAIN_MOMENT_REL = 6e-5
LM_TRAIN_PARAM_REL = 3e-7
# each device's parameters after its own first step from zero moments, where
# Adam's update is g / (|g| + eps) + wd p: every element within 2 lr (the
# update's term lies in (-1, 1); the slack is a rounding of a |p| <= 2 at lr
# 3e-4; 1.5e-2 lr measured), and the elements whose gradient is 1e4 eps or
# more on both devices, with one sign, within LM_TRAIN_OWN_REL of the leaf's
# scale (their update terms differ by eps / |g| times the gradients'
# relative difference at most), about 3x the largest reading (1.9e-7)
LM_TRAIN_OWN_LR = 2.001
LM_TRAIN_OWN_G = 1e-4
LM_TRAIN_OWN_REL = 6e-7
LM_TRAIN_LR = 3e-4        # make_train_step's default base rate
LM_TRAIN_CELL = dict(arch="qwen2.5-3b", batch=4, seq=1024, steps=8, seed=0)
LM_RESUME_CELL = dict(arch="mamba2-130m", batch=8, seq=512, steps=40, ckpt_every=20, seed=0)
PROBE = dict(n=4096, seq=64, chunk=512, n_lambdas=6, lam_min_ratio=0.15, seed=1)
PROBE_FIXED_ITERS = 200  # the probe's card-vs-CPU paths: FISTA iterations a step
PROBE_CPU_REL = 1e-5


def train_batch(cfg, pipe, step, B, device, seed) -> dict:
    """The pipeline's batch ``step`` on ``device``, with an enc-dec model's
    frame or a VLM's prefix embeddings (:func:`lm_extras`)."""
    b = {k: torch.from_numpy(v) for k, v in pipe.batch_at(step).items()}
    b.update(lm_extras(cfg, B, seed))
    return {k: v.to(device) for k, v in b.items()}


def train_state_to(state, device):
    """A copy of a ``TrainState`` on ``device``."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim import AdamWState
    from repro_torch.tree import tree_map

    mv = lambda t: t.to(device, copy=True)  # noqa: E731
    opt = state.opt
    return TrainState(params=tree_map(mv, state.params),
                      opt=AdamWState(mv(opt.step), tree_map(mv, opt.mu), tree_map(mv, opt.nu)))


def leaf_errors(got, want) -> float:
    """The largest |got - want| / max |want| over two trees' leaves."""
    want = dict(lm_leaves(want))
    worst = 0.0
    for path, t in lm_leaves(got):
        scale = float(want[path].abs().max())
        d = float((t.detach().double().cpu() - want[path].double().cpu()).abs().max())
        worst = max(worst, d / scale if scale else d)
    return worst


def own_step_errors(card, cpu, lr, b1=0.9) -> dict:
    """Each device's parameters after its own first step from zero moments
    (``LM_TRAIN_OWN_*``): the largest |card - cpu| over ``lr``, and over the
    leaf's scale on the elements whose gradient (the first moment over
    ``1 - b1``) is ``LM_TRAIN_OWN_G`` or more on both devices with one sign,
    with the count of those elements."""
    want_p, want_m = dict(lm_leaves(cpu.params)), dict(lm_leaves(cpu.opt.mu))
    got_m = dict(lm_leaves(card.opt.mu))
    over_lr = strong_rel = 0.0
    n_strong = 0
    for path, p in lm_leaves(card.params):
        want = want_p[path].double()
        d = (p.detach().double().cpu() - want).abs()
        over_lr = max(over_lr, float(d.max()) / lr)
        g_card = got_m[path].double().cpu() / (1 - b1)
        g_cpu = want_m[path].double() / (1 - b1)
        strong = (g_card * g_cpu > 0) & (torch.minimum(g_card.abs(), g_cpu.abs())
                                         >= LM_TRAIN_OWN_G)
        if strong.any():
            strong_rel = max(strong_rel, float(d[strong].max() / want.abs().max()))
            n_strong += int(strong.sum())
    return {"max_over_lr": over_lr, "strong_rel": strong_rel, "strong_elements": n_strong}


def phase_lm_train_card_vs_cpu(configs, steps_mod) -> None:
    """The ten SMOKE configs in float32 (TF32 off), the same initial state on
    the card and the CPU, one ``make_train_step`` step (no warmup: the rate
    is nonzero from step 0): its loss, ``ce``, ``aux`` and grad norm within
    ``LM_TRAIN_LOSS_REL``; both moments after the update (which carry the
    gradients) within ``LM_TRAIN_MOMENT_REL`` of each leaf's scale; and the
    parameters after the update within ``LM_TRAIN_PARAM_REL``, the card's
    AdamW fed the CPU's gradients. Each device's parameters after its own
    step are held by :func:`own_step_errors`, not to the leaf's scale as a
    whole: Adam's first step is g / (|g| + eps), so an element whose
    gradient is at rounding level (~1e-8, eps's size) moves by up to lr
    either way, and a bias leaf that starts at 0 has lr for its scale. Then
    3 more steps' losses within ``LM_TRAIN_LOSS_REL``, and the
    card's loss and gradients under ``remat`` none, full and dots, within
    the loss's and the moments' tolerances and reported bit for bit or not (the
    SMOKE configs train with ``full``: an MoE's routing must come out the
    same when its unit is recomputed in the backward pass)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import adamw_update, cosine_schedule, global_norm

    t0 = time.perf_counter()
    report = {}
    for i, arch in enumerate(configs.ARCHS):
        cfg = configs.get_smoke_config(arch).replace(dtype="float32")
        S = LM_TRAIN_SEQ.get(arch, 32)
        start = steps_mod.init_train_state(cfg, torch.Generator().manual_seed(50 + i), "cpu")
        card, cpu = train_state_to(start, "cuda"), train_state_to(start, "cpu")
        kw = dict(base_lr=LM_TRAIN_LR, warmup_steps=0, total_steps=8)
        step = steps_mod.make_train_step(cfg, **kw)
        pipe = TokenPipeline(cfg.vocab_size, 2, S, seed=50 + i)
        out = {"seq": S, "train_remat": cfg.remat}
        losses = {"card": [], "cpu": []}
        for s in range(1 + LM_TRAIN_STEPS):
            if s == 0:  # the CPU's gradients of the first step, for the card's AdamW
                _, _, g_cpu = steps_mod._value_and_grads(
                    cfg, start.params, train_batch(cfg, pipe, 0, 2, "cpu", 50 + i))
            card, mg = step(card, train_batch(cfg, pipe, s, 2, "cuda", 50 + i))
            cpu, mc = step(cpu, train_batch(cfg, pipe, s, 2, "cpu", 50 + i))
            require(mg["skipped"] == mc["skipped"] == 0, f"lm_train {arch}: step {s} skipped")
            losses["card"].append(mg["loss"])
            losses["cpu"].append(mc["loss"])
            if s == 0:
                out["first_step"] = {k: abs(mg[k] - mc[k]) / abs(mc[k]) if mc[k] else
                                     abs(mg[k] - mc[k]) for k in ("loss", "ce", "aux", "grad_norm")}
                out["moments_rel"] = max(leaf_errors(card.opt.mu, cpu.opt.mu),
                                         leaf_errors(card.opt.nu, cpu.opt.nu))
                out["params_rel_own_gradients"] = leaf_errors(card.params, cpu.params)
                out["params_own_step"] = own_step_errors(card, cpu, mc["lr"])
                same = train_state_to(start, "cuda")
                g = [x.cuda() for x in g_cpu]
                lr = cosine_schedule(same.opt.step, LM_TRAIN_LR, 0, 8)
                adamw_update(g, same.opt, same.params, lr, gnorm=global_norm(g))
                out["params_rel_same_gradients"] = leaf_errors(same.params, cpu.params)
                del same, g, g_cpu
        out["losses_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
        require(max(*out["first_step"].values(), out["losses_rel"]) <= LM_TRAIN_LOSS_REL,
                f"lm_train {arch}: card vs CPU {out}")
        own = out["params_own_step"]
        require(out["moments_rel"] <= LM_TRAIN_MOMENT_REL
                and out["params_rel_same_gradients"] <= LM_TRAIN_PARAM_REL
                and own["max_over_lr"] <= LM_TRAIN_OWN_LR
                and own["strong_rel"] <= LM_TRAIN_OWN_REL and own["strong_elements"] > 0,
                f"lm_train {arch}: leaves card vs CPU {out}")
        # remat none / full / dots on the card, from the stepped state
        b = train_batch(cfg, pipe, 9, 2, "cuda", 50 + i)
        runs = {}
        for remat in ("none", "full", "dots"):
            loss, _, g = steps_mod._value_and_grads(cfg.replace(remat=remat), card.params, b)
            runs[remat] = (loss, g)
        base_loss, base_g = runs["none"]
        out["remat"] = {}
        for remat in ("full", "dots"):
            loss, g = runs[remat]
            err = max(float((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
                      for a, c in zip(g, base_g))
            lrel = abs(float(loss) - float(base_loss)) / abs(float(base_loss))
            out["remat"][remat] = {"loss_rel": lrel, "grad_rel": err,
                                   "bitwise": bool(torch.equal(loss, base_loss)) and all(
                                       torch.equal(a, c) for a, c in zip(g, base_g))}
            require(lrel <= LM_TRAIN_LOSS_REL and err <= LM_TRAIN_MOMENT_REL,
                    f"lm_train {arch}: remat {remat} against none {out['remat'][remat]}")
        report[arch] = out
        del cpu, card, runs
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lm_train_card_vs_cpu", "tolerance_loss_rel": LM_TRAIN_LOSS_REL,
          "tolerance_moment_rel": LM_TRAIN_MOMENT_REL,
          "tolerance_param_rel": LM_TRAIN_PARAM_REL, "tolerance_own_step_over_lr": LM_TRAIN_OWN_LR,
          "tolerance_own_step_rel": LM_TRAIN_OWN_REL, "steps": 1 + LM_TRAIN_STEPS, **report,
          "seconds": time.perf_counter() - t0})


def lm_train_bound(cfg, params, B, S) -> dict:
    """One train step's bound (``remat="full"``: each unit's forward runs
    twice, the head's once):

    * bf16 products: 2 flops a weight entry a token forward, 4 backward, 2
      more for the recomputed units (every weight but the embedding table;
      the head once forward and twice backward);
    * float32 attention: QK and PV, 4 flops per head dimension per causal
      (query, key) pair a layer, S (S + 1) / 2 pairs a sequence, run four
      times (forward, recompute, twice backward);
    * bytes: the masters read once forward, the gradients written once, and
      the update's read of parameters, gradients and both moments and write
      of parameters and moments (7 float32 passes over the parameters).
    """
    from repro_torch.models.transformer import PRODUCT_LEAVES

    layer = sum(t.numel() for path, t in lm_leaves(params)
                if path[0] == "segments" and path[-1] in PRODUCT_LEAVES)
    head = (params["head"] if "head" in params else params["embed"]["tok"]).numel()
    n_params = sum(t.numel() for _, t in lm_leaves(params))
    tokens = B * S
    bf16 = tokens * (8 * layer + 6 * head)
    pairs = B * S * (S + 1) // 2
    f32 = 4 * (4 * cfg.num_heads * cfg.resolved_head_dim * pairs * cfg.num_layers)
    nbytes = 4 * n_params * (1 + 1 + 7)
    ms, by = lm_bound(bf16, f32, nbytes)
    return {"bound_ms": ms, "bound_by": by, "bf16_flops": bf16, "f32_flops": f32,
            "bytes": nbytes, "params": n_params}


def profile_train_step(step, state, batch, rows: int = 10) -> tuple:
    """``(state, profile)``: one train step under ``torch.profiler`` (which
    slows it about 2x): the card's busy share over the step, its kernels,
    the update's kernels and their device ms (the step's host fetch comes
    before its ``train_step.update`` region, so every kernel that starts
    after the region begins is the update's), and the ``rows`` operators
    with the most device time of their own."""
    with tempfile.TemporaryDirectory() as tmp:
        trace = f"{tmp}/train.json"
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("path"):
                state, _ = step(state, batch)
                torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        share, names, _ = busy_share(trace)
        events = json.loads(Path(trace).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    region = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    update = [e for e in kernels if e["ts"] >= region["train_step.update"]["ts"]]
    ops = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:rows]
    return state, {"busy_share": share, "kernels_a_step": len(kernels),
                   "kernel_names": len(names), "profiled_step_ms": region["path"]["dur"] / 1e3,
                   "update_kernels": len(update),
                   "update_device_ms": sum(e["dur"] for e in update) / 1e3,
                   "top_ops": [{"op": e.key, "calls": e.count,
                                "device_ms": e.self_device_time_total / 1e3} for e in ops]}


def phase_lm_train(configs, steps_mod) -> tuple:
    """qwen2.5-3b's published configuration trained on the card: bf16
    products over float32 masters and float32 moments, ``remat="full"``,
    ``TokenPipeline(seed=0)`` at 4 x 1,024 tokens, 8 steps of
    ``make_train_step(total_steps=8)``. Checks: every loss finite, no step
    skipped, the peak under the card's memory. Prints the step's ms (median
    of steps 2-7, each from a synchronized start to the end of its update's
    kernels), tokens/s, the bound (:func:`lm_train_bound`) and its share, a
    profiled step (:func:`profile_train_step`) with the update's device ms
    as a share of the median step, the peak.
    Returns the trained state and the config, for the probe."""
    from repro_torch.data import TokenPipeline

    c = LM_TRAIN_CELL
    cfg = configs.get_config(c["arch"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = steps_mod.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(c["seed"]),
                                       "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = lm_bytes(state.params) + lm_bytes(state.opt.mu) + lm_bytes(state.opt.nu)
    step = steps_mod.make_train_step(cfg, total_steps=c["steps"])
    pipe = TokenPipeline(cfg.vocab_size, c["batch"], c["seq"], seed=c["seed"])
    walls, metrics = [], []
    for s in range(c["steps"]):
        b = train_batch(cfg, pipe, s, c["batch"], "cuda", c["seed"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()    # the step ends in its update's kernels
        walls.append(time.perf_counter() - t1)
        metrics.append(m)
    losses = [m["loss"] for m in metrics]
    require(all(math.isfinite(x) for x in losses), f"lm_train: a loss is not finite {losses}")
    require(not any(m["skipped"] for m in metrics), "lm_train: a step was skipped")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    require(peak < total, f"lm_train: peak {peak / 1e9:.1f} GB")
    step_s = float(np.median(walls[2:8]))
    state, prof = profile_train_step(
        step, state, train_batch(cfg, pipe, c["steps"], c["batch"], "cuda", c["seed"]))
    prof["update_share_of_step"] = prof["update_device_ms"] / (step_s * 1e3)
    bound = lm_train_bound(cfg, state.params, c["batch"], c["seq"])
    tokens = c["batch"] * c["seq"]
    emit({"phase": "lm_train", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "d_ff": cfg.d_ff, "vocab": cfg.padded_vocab, "dtype": cfg.dtype,
          "param_dtype": cfg.param_dtype, "remat": cfg.remat, "reduced": {},
          "params": bound["params"], "state_bytes": state_bytes, "init_s": init_s,
          "batch": c["batch"], "seq": c["seq"], "steps": c["steps"], "losses": losses,
          "lr": [m["lr"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics],
          "step_walls_s": walls, "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
          **{k: bound[k] for k in ("bound_ms", "bound_by", "bf16_flops", "f32_flops", "bytes")},
          "bound_share": bound["bound_ms"] / (step_s * 1e3), "profile": prof,
          "peak_gbytes": peak / 1e9, "card_gbytes": total / 1e9})
    return state, cfg


LM_MESH = dict(prompt=64, seed=5, budget_s=30.0)
#: the dry run's meshes of the ``lm_mesh`` phase: (1, 1) and the reference's two
LM_MESH_SHAPES = {"1x1": ((1, 1), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
                  "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def phase_lm_mesh(state, cfg) -> None:
    """The LM mesh, sharding rules and dry run on ``lm_train``'s trained
    state (already on the card; no big allocation but one copy of the
    parameters). Checks: the dry run's per-rank state bytes (parameters
    and both moments, ``dryrun.train_state_arguments`` on a fake world) on
    (1, 1) equal the state's own bytes exactly; on a real (1, 1) CUDA
    ``DeviceMesh`` over NCCL (``make_host_mesh``, a world of one) the
    parameters placed by ``param_shardings`` hold each leaf whole as their
    local shard, bit for bit; a prefill of 1 x 64 tokens through the placed
    parameters (DTensors, under the ambient mesh) gives the plain prefill's
    logits bit for bit; the process group is destroyed before the next
    phase; the phase within its budget. Prints the (16, 16) and (2, 16, 16)
    per-rank bytes of the same state (arithmetic of the placements, no
    reading of any device)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.models import sharding
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves, tree_keys

    c = LM_MESH
    t0 = time.perf_counter()
    dev = leaves(state.params)[0].device
    state_bytes = lm_bytes(state.params) + lm_bytes(state.opt.mu) + lm_bytes(state.opt.nu)
    per_rank = {}
    for name, (shape, names) in LM_MESH_SHAPES.items():
        with fake_world(math.prod(shape)):
            st = dryrun.train_state_arguments(
                cfg, init_device_mesh("cpu", shape, mesh_dim_names=names),
                moment_dtype=leaves(state.opt.mu)[0].dtype)
            per_rank[name] = {g: dryrun.local_bytes(t) for g, t in
                              (("params", st.params), ("mu", st.opt.mu), ("nu", st.opt.nu))}
    require(sum(per_rank["1x1"].values()) == state_bytes,
            f"lm_mesh: dry-run (1, 1) state bytes {per_rank['1x1']} against {state_bytes}")
    require(not dist.is_initialized(), "lm_mesh: a fake world outlived its block")

    tokens = torch.randint(0, cfg.vocab_size, (1, c["prompt"]), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(c["seed"]))
    with torch.no_grad():
        want, _ = tr.prefill(state.params, cfg, {"tokens": tokens})
    mesh = make_host_mesh(device=dev.type)
    try:
        require(tuple(mesh.shape) == (1, 1) and mesh.device_type == dev.type
                and dist.get_world_size() == 1, f"lm_mesh: the card mesh is {mesh}")
        t1 = time.perf_counter()
        placed = sharding.param_shardings(state.params, mesh)
        place_s = time.perf_counter() - t1
        whole = tree_keys(state.params)
        for path, t in tree_keys(placed).items():
            local = t.to_local()
            require(local.device == dev and local.dtype == whole[path].dtype
                    and torch.equal(local, whole[path]),
                    f"lm_mesh: {path}'s local shard is not the whole leaf")
        tok = distribute_tensor(tokens, mesh, sharding.to_placements(("data", None), mesh),
                                src_data_rank=None)
        t1 = time.perf_counter()
        with torch.no_grad(), sharding.set_mesh(mesh), implicit_replication():
            got, _ = tr.prefill(placed, cfg, {"tokens": tok})
            got = got.full_tensor()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        require(torch.equal(got, want),
                f"lm_mesh: the placed prefill's logits differ by "
                f"{float((got.float() - want.float()).abs().max())}")
        del placed, got
    finally:
        dist.destroy_process_group()
    require(not dist.is_initialized(), "lm_mesh: the card's process group outlived the phase")
    seconds = time.perf_counter() - t0
    require(seconds <= c["budget_s"], f"lm_mesh: {seconds:.1f} s over its {c['budget_s']} s")
    emit({"phase": "lm_mesh", "arch": cfg.name, "state_bytes": state_bytes,
          "per_rank_state_bytes": per_rank, "card_mesh": [1, 1], "backend": "nccl"
          if dev.type == "cuda" else "gloo", "leaves": len(whole), "place_s": place_s,
          "prefill_tokens": c["prompt"], "prefill_bitwise": True, "prefill_s": prefill_s,
          "seconds": seconds})


LM_MESH_MOE = dict(prompt=64, seed=7, f32_rel=1e-5, bf16_rel=3e-2,
                   archs=("deepseek-v2-236b", "arctic-480b"))


def route_moves(mesh_calls, plain_calls) -> list:
    """The (layer, group, token) positions whose experts differ between the
    mesh run and the plain one, each with the swapped experts' logits in
    both runs and whether it is a near tie (:func:`near_tie`)."""
    moves = []
    for layer, (a, b) in enumerate(zip(mesh_calls, plain_calls)):
        ta, tb = a["top_i"], b["top_i"]
        for g, t in torch.nonzero((ta.sort(-1).values != tb.sort(-1).values).any(-1)).tolist():
            sa, sb = set(ta[g, t].tolist()), set(tb[g, t].tolist())
            la, lb = a["logits"][g, t], b["logits"][g, t]
            tie = all(any(near_tie(la, lb, x, y) for y in sb - sa) for x in sa - sb)
            moves.append({"layer": layer, "group": g, "token": t, "mesh": sorted(sa - sb),
                          "plain": sorted(sb - sa), "near_tie": tie})
    return moves


def mesh_prefill(tr, cfg, params, tokens) -> dict:
    """``tr.prefill`` of ``tokens`` on plain ``params``, then through the
    same parameters placed on a (1, 1) mesh on the card (``make_host_mesh``:
    NCCL), under the ambient mesh; the process group is destroyed
    before it returns. Returns both runs' logits, caches (whole) and
    routes, and the mesh run's seconds."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding
    from repro_torch.testing.lm import RouteRecorder
    from repro_torch.tree import tree_map

    with torch.no_grad(), RouteRecorder(keep=True) as plain:
        want, want_cache = tr.prefill(params, cfg, {"tokens": tokens})
    mesh = make_host_mesh()
    try:
        require(tuple(mesh.shape) == (1, 1) and dist.get_world_size() == 1,
                f"lm_mesh_moe: the mesh is {mesh}")
        placed = sharding.param_shardings(params, mesh)
        tok = distribute_tensor(tokens, mesh, sharding.to_placements(("data", None), mesh),
                                src_data_rank=None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), sharding.set_mesh(mesh), implicit_replication(), \
                RouteRecorder(keep=True) as on_mesh:
            got, cache = tr.prefill(placed, cfg, {"tokens": tok})
            got = got.full_tensor()
            cache = tree_map(lambda t: t.full_tensor(), cache)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        del placed
    finally:
        dist.destroy_process_group()
    require(not dist.is_initialized(), "lm_mesh_moe: the process group outlived the prefill")
    require(len(on_mesh.calls) == len(plain.calls) == cfg.num_layers,
            f"lm_mesh_moe: {len(on_mesh.calls)} and {len(plain.calls)} MoE calls")
    return {"logits": (got, want), "cache": (cache, want_cache), "seconds": seconds,
            "moves": route_moves(on_mesh.calls, plain.calls)}


def phase_lm_mesh_moe(configs, tr) -> None:
    """The MoE layer's mesh form (the reference's one-hot dispatch and
    combine over all experts, ``models/moe.py`` ``_experts_onehot``) on
    the card: a 1 x 64 prefill through placed parameters on a (1, 1)
    mesh against the plain prefill on the same parameters (the scatter into
    the experts that hold a token). deepseek-v2-236b's and arctic-480b's
    reduced configs in float32: the routing equal, the logits and every
    float32 cache leaf within rel ``LM_MESH_MOE["f32_rel"]``, a bf16 leaf
    equal but for values rounded to the other neighbour (``bf16_flips``,
    counted). deepseek-v2-236b's
    widths on 2 of 60 layers (``lm_serve_moe``'s cell), bf16 over float32
    masters drawn from a seeded generator: the routing equal but for named
    near ties, the logits within ``LM_MESH_MOE["bf16_rel"]``, or
    ``LM_FLIP_REL`` when a route moved. Prints the seconds and the peak
    memory."""
    from repro_torch.tree import tree_keys

    c = LM_MESH_MOE
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for arch in c["archs"]:
        cfg = configs.get_smoke_config(arch).replace(dtype="float32")
        params = tr.init_params(cfg, torch.Generator(device="cuda").manual_seed(c["seed"]),
                                "cuda")
        tokens = torch.randint(0, cfg.vocab_size, (1, c["prompt"]), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(c["seed"]))
        r = mesh_prefill(tr, cfg, params, tokens)
        want = tree_keys(r["cache"][1])
        cache_rel, flips = 0.0, 0
        for k, t in tree_keys(r["cache"][0]).items():
            if t.dtype == torch.bfloat16:  # a value may round to the other neighbour
                n, explained = bf16_flips(t, want[k])
                require(explained, f"lm_mesh_moe {arch}: cache {k} differs past a rounding")
                flips += n
            else:
                cache_rel = max(cache_rel, rel_err(t, want[k]))
        logits_rel = rel_err(*r["logits"])
        require(not r["moves"], f"lm_mesh_moe {arch}: routes moved {r['moves'][:4]}")
        require(logits_rel <= c["f32_rel"] and cache_rel <= c["f32_rel"],
                f"lm_mesh_moe {arch}: logits rel {logits_rel}, cache rel {cache_rel}")
        out[f"{arch}_smoke_f32"] = {"logits_rel": logits_rel, "cache_rel": cache_rel,
                                    "cache_bf16_flips": flips, "mesh_prefill_s": r["seconds"]}
        del params, r

    cell = next(x for x in LM_CELLS if x.phase == "lm_serve_moe")
    cfg = cell.config(configs)
    masters = tr.init_params(cfg, torch.Generator(device="cuda").manual_seed(LM_SEED), "cuda")
    weights = tr.serving_params(masters, cfg)
    del masters
    tokens = torch.randint(0, cfg.vocab_size, (1, c["prompt"]), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(c["seed"]))
    r = mesh_prefill(tr, cfg, weights, tokens)
    del weights
    logits_rel = rel_err(*r["logits"])
    moved = bool(r["moves"])
    finite = bool(torch.isfinite(r["logits"][0]).all())
    require(finite, "lm_mesh_moe: a non-finite logit on the mesh")
    require(all(m["near_tie"] for m in r["moves"]),
            f"lm_mesh_moe: a route moved off a near tie: {r['moves'][:4]}")
    tol = LM_FLIP_REL if moved else c["bf16_rel"]
    require(logits_rel <= tol, f"lm_mesh_moe: bf16 logits rel {logits_rel} (routes moved: {moved})")
    out[f"{cfg.name}_{cfg.num_layers}_layers_bf16"] = {
        "logits_rel": logits_rel, "tolerance": tol,
        "route_moves": r["moves"], "mesh_prefill_s": r["seconds"]}
    emit({"phase": "lm_mesh_moe", "prompt": c["prompt"], "mesh": [1, 1], "backend": "nccl",
          **out, "peak_gbytes": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})


QUICKSTART_REL = 1e-5  # its comparisons on the card, as the port's tests hold those paths


def phase_quickstart(quickstart, ops) -> dict:
    """``repro_torch.examples.quickstart.main`` on the card (its default
    device), in a temporary working directory, the launch
    counts set to 0 just before it and read just after: the margin,
    gradient, feature-screen and sample-sweep kernels each launched.
    Checks its comparisons within ``QUICKSTART_REL`` (max |a - b| / max(|b|,
    1)): the reduced against the full solve's objective, the out-of-core
    path against the in-core one, server job 0 against its sequential scan
    path; every objective finite. Prints the scan engines' paths against
    the host path (the default stop rule's fp32 jitter, up to ~8e-6, as
    the reference's own engines). Returns the launches."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = quickstart.main([])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
        finally:
            os.chdir(cwd)
    names = ("margin_obj", "hinge_grad", "screen_bounds", "sample_surplus")
    require(all(launches.get(k, 0) > 0 for k in names),
            f"quickstart: a kernel of its paths was never launched: {launches}")

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))

    path = out["path"]
    checks = {"reduced_vs_full": rel(out["obj_reduced"], out["obj_full"]),
              "out_of_core_vs_in_core": rel(out["out_of_core"].objectives,
                                            out["in_core"].objectives),
              "server_job0_vs_sequential": rel(out["server_job0"].objectives,
                                               out["server_seq0"].objectives)}
    require(all(v <= QUICKSTART_REL for v in checks.values()), f"quickstart: {checks}")
    # the engines at the default stop rule: fp32 stop-rule jitter, printed only
    engines = {"scan_vs_host": rel(out["scan"].objectives, path.objectives),
               "compact_vs_host": rel(out["compact"].objectives, path.objectives)}
    results = [path, out["scan"], out["compact"], out["dynamic"], out["out_of_core"],
               out["in_core"], out["server_job0"], *out["rules"].values()]
    require(all(bool(np.all(np.isfinite(r.objectives))) for r in results),
            "quickstart: a non-finite objective")
    emit({"phase": "quickstart", "wall_s": wall, "lambda_max": out["lambda_max"],
          "kept_at_0.7": int(out["keep"].sum()), "checks": checks, "engines": engines,
          "tolerance": QUICKSTART_REL, "launches": {k: launches.get(k, 0) for k in names},
          "server": {k: out["server"].last_serve[k]
                     for k in ("jobs_per_s", "slot_occupancy", "programs", "hits",
                               "retraces")}})
    return launches


def phase_lm_train_resume(configs, steps_mod, train_mod) -> None:
    """The trainer ``train()`` on mamba2-130m whole, on the card, 8 x 512
    tokens: 40 steps uninterrupted (checkpoints every 20), and 20 steps then
    a resume to 40 in a second directory, under
    ``torch.use_deterministic_algorithms`` (the embedding's and the MoE's
    index writes and their backward otherwise accumulate with atomics):
    the resumed steps' losses and the final parameters and moments equal to
    the uninterrupted run's bit for bit, unless an operation on the path
    has no deterministic implementation (named from torch's warning, and
    then held to rel 1e-6). Also the mean of the last 5 losses below the
    first 5's; prints seconds a step (the trainer's walls: a step's wall
    runs to its host fetch, which waits for the previous step's update, so
    the median is the period of the loop), a save's seconds and bytes, and
    one step of the 20-step run's state profiled (:func:`profile_train_step`,
    deterministic algorithms still on)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import TokenPipeline
    from repro_torch.tree import leaves

    c = LM_RESUME_CELL
    kw = dict(smoke=False, batch=c["batch"], seq=c["seq"], ckpt_every=c["ckpt_every"],
              seed=c["seed"], log=_quiet, device="cuda")
    det, det_warn = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS's deterministic setting
    t0 = time.perf_counter()
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught, \
                tempfile.TemporaryDirectory() as tmp:
            warnings.simplefilter("always")
            full = train_mod.train(c["arch"], steps=c["steps"], ckpt_dir=f"{tmp}/full", **kw)
            part = train_mod.train(c["arch"], steps=c["steps"] // 2, ckpt_dir=f"{tmp}/res",
                                   **kw)
            resumed = train_mod.train(c["arch"], steps=c["steps"], ckpt_dir=f"{tmp}/res", **kw)
            mgr = CheckpointManager(f"{tmp}/save")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            saved = mgr.save(c["steps"], full["final_state"])
            save_s = time.perf_counter() - t1
            save_bytes = sum(p.stat().st_size for p in saved.iterdir())
            cfg = configs.get_config(c["arch"])
            pipe = TokenPipeline(cfg.vocab_size, c["batch"], c["seq"], seed=c["seed"])
            _, prof = profile_train_step(
                steps_mod.make_train_step(cfg, total_steps=c["steps"]), part["final_state"],
                train_batch(cfg, pipe, c["steps"] // 2, c["batch"], "cuda", c["seed"]))
    finally:
        torch.use_deterministic_algorithms(det, warn_only=det_warn)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
    refused = sorted({str(w.message).split(" does not have a deterministic")[0]
                      for w in caught if "deterministic" in str(w.message)})
    half = c["steps"] // 2
    a, b = leaves(full["final_state"]), leaves(resumed["final_state"])
    bitwise = (resumed["losses"] == full["losses"][half:]
               and part["losses"] == full["losses"][:half]
               and all(torch.equal(x, y) for x, y in zip(a, b)))
    leaf_rel = max(float((x.double() - y.double()).abs().max()
                         / y.double().abs().max().clamp_min(1e-30)) for x, y in zip(a, b))
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(resumed["losses"], full["losses"][half:]))
    if refused:
        require(max(leaf_rel, loss_rel) <= 1e-6,
                f"lm_train_resume: resumed run off by {leaf_rel}, {loss_rel}; refused {refused}")
    else:
        require(bitwise, f"lm_train_resume: not bit for bit (leaves {leaf_rel}, losses "
                         f"{loss_rel})")
    L = full["losses"]
    require(all(math.isfinite(x) for x in L) and full["skipped"] == 0,
            "lm_train_resume: a loss not finite or a step skipped")
    require(np.mean(L[-5:]) < np.mean(L[:5]), f"lm_train_resume: no descent {L}")
    emit({"phase": "lm_train_resume", **c, "deterministic_algorithms": True,
          "refused_determinism": refused, "bitwise": bitwise, "leaf_rel": leaf_rel,
          "loss_rel": loss_rel, "losses": L, "resumed_losses": resumed["losses"],
          "first5_mean": float(np.mean(L[:5])), "last5_mean": float(np.mean(L[-5:])),
          "step_ms_median": float(np.median(full["step_seconds"][1:])) * 1e3,
          "step_ms_first": full["step_seconds"][0] * 1e3,
          "save_s": save_s, "save_bytes": save_bytes, "profile": prof,
          "seconds": time.perf_counter() - t0})


def phase_sparse_probe(svm_path, PathDriver, lipschitz_estimate, ops, K, probe, state,
                       cfg) -> dict:
    """The paper's path on the LM's features at full width: qwen2.5-3b's
    trained parameters (``lm_train``) give final-norm last-position bf16
    features of 4,096 sequences of 64 tokens from ``default_rng(1)``; cast
    to float32 and standardized, X is 2,048 features x 4,096 samples, the
    labels the last token's parity. ``svm_path(n_lambdas=6,
    lam_min_ratio=0.15)`` on the card, the launch counts set to 0 just
    before it and read just after: the feature-screen, margin and gradient
    kernels each launched. Checks: safe against the unscreened path,
    objectives within 1e-4 of float64, card vs CPU (plain versions, the
    same L) within ``PROBE_CPU_REL`` at ``PROBE_FIXED_ITERS`` iterations a
    step, and the three kernels against their plain versions at this X's
    shape (and timed there, per call and by device time, beside
    ``torch.mv``). Then the reference-sized example's ``main`` on the card (SMOKE
    qwen2.5-3b, 30 steps, 192 sequences). Returns the path's launches."""
    p = PROBE
    t0 = time.perf_counter()
    rng = np.random.default_rng(p["seed"])
    toks = rng.integers(0, cfg.vocab_size, (p["n"], p["seq"])).astype(np.int32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    feats = probe.extract_features(state.params, cfg, torch.from_numpy(toks).cuda(), p["chunk"])
    torch.cuda.synchronize()
    feature_s = time.perf_counter() - t1
    require(feats.dtype == torch.bfloat16 and feats.shape == (p["n"], cfg.d_model)
            and bool(torch.isfinite(feats).all()), "sparse_probe: features")
    X_np, y_np = probe.probe_task(feats, toks)
    X, y = torch.from_numpy(X_np).cuda(), torch.from_numpy(y_np).cuda()
    grid = dict(n_lambdas=p["n_lambdas"], lam_min_ratio=p["lam_min_ratio"])
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = svm_path(X, y, device="cuda", **grid)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    require(all(launches[k] > 0 for k in ("screen_bounds", "margin_obj", "hinge_grad")),
            f"sparse_probe: a kernel of the path was never launched: {launches}")
    require(bool(np.all(np.isfinite(res.objectives))), "sparse_probe: non-finite objective")
    phase_objective_check(res, X, y, phase="sparse_probe_objective_f64")
    full = svm_path(X, y, lambdas=res.lambdas, screening=False, device="cuda")
    safety = []
    for k in range(1, len(res.lambdas)):
        support, missed = missed_features(full, k, res.extras["keep_masks"][k])
        safety.append({"step": k, "support": support, "kept": int(res.kept[k]),
                       "missed": missed})
        require(missed == 0, f"sparse_probe step {k}: {missed} active features screened out")
    L = float(lipschitz_estimate(X))
    fixed = dict(L=L, tol=-1.0, max_iters=PROBE_FIXED_ITERS)
    card = PathDriver(device="cuda", **fixed).run(X, y, **grid)
    cpu = PathDriver(device="cpu", **fixed).run(X_np, y_np, **grid)
    cpu_rel = float(np.max(np.abs(card.objectives - cpu.objectives) / np.abs(cpu.objectives)))
    require(cpu_rel <= PROBE_CPU_REL, f"sparse_probe: card vs CPU rel {cpu_rel}")
    # the three kernels against their plain versions at this X's shape
    m, n = X.shape
    gen = torch.Generator().manual_seed(p["seed"])
    w = torch.from_numpy(res.weights[-1]).float().cuda()
    b = torch.tensor(float(res.biases[-1]), device="cuda")
    xi = torch.rand(n, generator=gen).cuda()
    lmax = float(res.extras["lam_max"])
    theta = K.theta_max(y, lmax)
    sh = K.shared_scalars(y, lmax, float(res.lambdas[1]), theta, delta=0.0)
    checks = {"margin_obj": K.margin(X, w, y, b, m, "sparse_probe"),
              "hinge_grad": K.grad(X, y, xi, m, "sparse_probe"),
              "screen_bounds": K.bounds(X, y, theta, sh, "sparse_probe")}
    # the three kernels' times at this shape, per call and by device time,
    # beside the library call reading the same bytes
    h, sc = K.hinge, K.screen
    v = y * xi
    packed = sc.pack_shared(sh)
    timing = {
        "margin_obj": {
            "ms": timed_ms(lambda: h.margin_obj_op(X, w, y, b), 50),
            "device_ms": device_ms(lambda: h.margin_obj_op(X, w, y, b), 50),
            "library_ms": timed_ms(lambda: torch.mv(X.t(), w), 50),
            "library_device_ms": device_ms(lambda: torch.mv(X.t(), w), 50)},
        "hinge_grad": {
            "ms": timed_ms(lambda: h.hinge_grad_op(X, y, xi), 50),
            "device_ms": device_ms(lambda: h.hinge_grad_op(X, y, xi), 50),
            "library_ms": timed_ms(lambda: torch.mv(X, v), 50),
            "library_device_ms": device_ms(lambda: torch.mv(X, v), 50)},
        "screen_bounds": {
            "ms": timed_ms(lambda: sc.screen_bounds_from_shared(X, y, theta, sh,
                                                                scalars=packed), 50),
            **screen_device_times(sc, X, y, theta, packed, None, False, "screen_bounds",
                                  50)},
        "bound_ms": m * n * 4 / HBM_BYTES_PER_S * 1e3}
    example = probe.main(["--device", "cuda"])
    require(bool(np.all(np.isfinite(example["path"].objectives))),
            "sparse_probe: the example's path")
    emit({"phase": "sparse_probe", "arch": cfg.name, "dtype": cfg.dtype, **p,
          "shape": [m, n], "feature_s": feature_s, "path_s": path_s,
          "lambdas": res.lambdas.tolist(), "kept": res.kept.tolist(),
          "active": res.active.tolist(), "iters": res.solver_iters.tolist(),
          "objectives": res.objectives.tolist(), "launches": launches,
          "safety": safety, "fixed_iters": PROBE_FIXED_ITERS, "card_vs_cpu_rel": cpu_rel,
          "tolerance_cpu_rel": PROBE_CPU_REL,
          "kernels": {k: max(v[x]["max_abs_err"] for x in v if isinstance(v[x], dict))
                      if k == "margin_obj" else v["max_abs_err"] for k, v in checks.items()},
          "timing": timing,
          "accuracy": float(np.mean(np.sign(res.weights[-1] @ X_np + res.biases[-1]) == y_np)),
          "example": {"accuracy": example["accuracy"], "loss": example["loss"],
                      "kept": example["path"].kept.tolist()},
          "seconds": time.perf_counter() - t0})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.dual import lambda_max, theta_at_lambda_max
    from repro_torch.core import solver
    from repro_torch.core.path import PathDriver, svm_path
    from repro_torch.core import distributed
    from repro_torch.core.path_scan import (
        clear_engine_cache,
        compact_caps_batched,
        engine_cache_info,
        svm_path_batched,
        svm_path_scan,
        svm_path_scan_sharded,
    )
    from repro_torch.core.solver import lipschitz_estimate
    from repro_torch.core.rules import AutoRule, SampleVIRule
    from repro_torch.core.screening import (
        edpp_scalars,
        edpp_scalars_from_stats,
        screen_bounds,
        shared_scalars,
        shared_scalars_from_stats,
    )
    from repro_torch.data import make_sparse_classification
    from repro_torch.kernels import build, hinge, ops, screen
    from repro_torch.core import path_scan
    from repro_torch.launch import path_server
    from repro_torch.launch.path_server import PathJob, PathServer, demo_jobs
    from repro_torch.launch.train_svm import main as train_main
    from repro_torch import configs
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch import train as lm_train
    from repro_torch.examples import quickstart, sparse_probe
    from repro_torch.models import transformer as tr
    from repro_torch.obs import trace as obs_trace
    import repro_torch.sparse as sparse
    from repro_torch.testing import faults

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the full-width data (seeds 0 and 1) is made on the host in the
    # background while the card builds and checks the kernels
    pool = ThreadPoolExecutor(max_workers=2)
    data = [pool.submit(make_sparse_classification, **{**FULL, "seed": s}) for s in (0, 1)]
    pool.shutdown(wait=False)
    info = phase_device()
    phase_build(build)
    gen = torch.Generator().manual_seed(1234)
    K = Kernels(hinge, screen, shared_scalars, shared_scalars_from_stats, edpp_scalars,
                edpp_scalars_from_stats, lambda_max, theta_at_lambda_max)
    phase_kernels_ragged(K, gen)

    t0 = time.perf_counter()
    ds = data[0].result()
    X_host = ds.X  # the out-of-core phase streams it from the host
    X = torch.from_numpy(ds.X).cuda()
    y = torch.from_numpy(ds.y).cuda()
    del ds
    emit({"phase": "data", "shape": list(X.shape), "dtype": str(X.dtype),
          "gbytes": X.numel() * 4 / 1e9, "seconds": time.perf_counter() - t0})

    phase_kernels_full(K, X, y, gen, lambda_max, theta_at_lambda_max)
    res, launches = phase_path(svm_path, ops, X, y)
    phase_objective_check(res, X, y)
    phase_small_vs_plain(PathDriver, lipschitz_estimate, make_sparse_classification)
    full = phase_safety(svm_path, res, X, y)
    res_c, launches_c = phase_composite_path(svm_path, ops, X, y)
    phase_composite_small_vs_plain(PathDriver, lipschitz_estimate,
                                   make_sparse_classification)
    launches_df = phase_dynamic_feature_path(svm_path, ops, X, y, res, full)
    launches_dc = phase_dynamic_composite_path(svm_path, ops, X, y)
    phase_dynamic_small_vs_plain(PathDriver, lipschitz_estimate,
                                 make_sparse_classification)
    rule_launches = {
        "edpp": phase_rule_path(svm_path, ops, X, y, "edpp", res, full),
        "auto": phase_rule_path(svm_path, ops, X, y, AutoRule(), res, full),
        "sifs": phase_sifs_path(svm_path, ops, X, y, SampleVIRule())[1],
    }
    phase_rules_small_vs_plain(PathDriver, lipschitz_estimate, make_sparse_classification)
    res_scan, engine_launches = phase_scan_path(svm_path, ops, solver.CHUNK_ITERS, X, y,
                                                res, full)
    engine_launches = {"scan": engine_launches}
    phase_scan_small_vs_plain(svm_path_scan, lipschitz_estimate, make_sparse_classification)
    engine_launches["batched"] = phase_batched_path(
        svm_path_batched, svm_path_scan, compact_caps_batched, lambda_max, ops,
        solver.CHUNK_ITERS, data[1], X, y, float(res.extras["lam_max"]))
    engine_launches["scan_dynamic"] = phase_scan_dynamic(
        svm_path, ops, solver.CHUNK_ITERS, X, y, res_scan, full)
    phase_engine_memory(clear_engine_cache, engine_cache_info, "scan_dynamic")
    engine_launches["serve"], serve_shapes = phase_serve(
        PathServer, PathJob, path_server, svm_path, clear_engine_cache,
        lipschitz_estimate, path_scan, K, gen, ops, X, y)
    phase_engine_memory(clear_engine_cache, engine_cache_info, "serve")
    phase_serve_snapshot(PathServer, demo_jobs, faults)
    phase_serve_faults(PathServer, demo_jobs, faults)
    phase_path_walls(svm_path, X, y)
    L_full = float(lipschitz_estimate(X))
    phase_checkpoint_resume(PathDriver, ops, X, y, L_full)
    phase_faults(PathDriver, sparse, faults, ops, res, full, X, y)
    phase_trace(svm_path, obs_trace, train_main, X, y)
    # the sharded phases: X saved once for the spawned ranks
    tmp = tempfile.TemporaryDirectory()
    X_path, y_path = f"{tmp.name}/X.npy", f"{tmp.name}/y.npy"
    np.save(X_path, X_host)
    np.save(y_path, y.cpu().numpy())
    single, launches_unit = phase_sharded_unit_grid(
        svm_path_scan, svm_path_scan_sharded, distributed.svm_grid, ops, X, y, L_full)
    composite = PathDriver(rules="composite", reduce="mask", L=L_full, tol=-1.0,
                           max_iters=GRID_ITERS, device="cuda").run(
        X, y, n_lambdas=N_LAMBDAS, lam_min_ratio=COMPOSITE_RATIO)
    ds_small = make_sparse_classification(m=2000, n=400, seed=11)
    small = {"X": ds_small.X, "y": ds_small.y,
             "L": float(lipschitz_estimate(torch.from_numpy(ds_small.X)))}
    grid22, lanes = phase_sharded_grid(distributed, screen_bounds, lambda_max,
                                       theta_at_lambda_max, X, y, X_path, y_path, single,
                                       full, composite, L_full, small)
    phase_host_lane_grid(PathDriver, svm_path_scan, grid22, lanes, small)
    grid22["small_inputs"] = small
    phase_sharded_small_vs_plain(distributed, grid22)
    tmp.cleanup()
    partial_t = phase_partial_timing(hinge, screen, shared_scalars, edpp_scalars, X, y)
    engine_launches["chunked"] = phase_chunked_path(
        PathDriver, svm_path, ops, sparse, screen, shared_scalars, screen_bounds,
        theta_at_lambda_max, X_host, X, y, res, full, float(lipschitz_estimate(X)))
    del X_host
    engine_launches["chunked_sparse"] = phase_chunked_sparse_path(
        PathDriver, ops, sparse, screen, shared_scalars, theta_at_lambda_max)
    phase_chunked_small_vs_plain(PathDriver, sparse.FeatureChunked, lipschitz_estimate,
                                 make_sparse_classification)
    rows = phase_timing(K, res, launches, res_c, launches_c,
                        {"feature": launches_df, "composite": launches_dc},
                        rule_launches, X, y, K.max_err, solver, engine_launches["serve"],
                        serve_shapes)
    for row in rows:  # the engines' paths: launches, and launches that did no work
        for label, counts in engine_launches.items():
            row[f"launches_{label}_path"] = int(counts[row["name"]])
            row[f"skipped_{label}_path"] = int(counts.get(f"skipped_{row['name']}", 0))

    partial_names = {"margin_obj": ("margin_partial", "margin_finalize"),
                     "screen_bounds": ("screen_partial", "screen_finalize"),
                     "sample_surplus": ("sample_partial", "sample_finalize")}
    for row in rows:  # the partial modes: times on a 2 x 2 block, sharded launches
        names = partial_names.get(row["name"])
        if names is None:
            continue
        t = partial_t[row["name"]]
        row["partial_mode"] = {
            "kernels": list(names), "shape": [X.shape[0] // 2, X.shape[1] // 2],
            **{k: t[k] for k in ("ms", "finalize_ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by", *DEVICE_KEYS) if k in t},
            "max_abs_err": max(t["max_abs_err"], K.max_err[names[0]]),
            **{f"launches_{run}_2x2_rank0": {nm: int(grid22["runs"][run]["launches"][nm])
                                             for nm in names}
               for run in ("path", "host")}}
        row["launches_sharded_unit_grid"] = int(launches_unit[row["name"]])

    # the LM scaffold's serving path, after the kernels' times: no kernel of
    # this repository on it, so it adds no row to the kernels line
    clear_engine_cache()
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm_card_vs_cpu(configs, tr, lm_serve)
    phase_lm_families_card_vs_cpu(configs, tr, lm_serve)
    for cell in LM_CELLS:
        phase_lm_serve(configs, tr, lm_serve, cell)
    # the LM training path, then the paper's path on its features (the
    # probe's launches join the kernels line)
    phase_lm_train_card_vs_cpu(configs, lm_steps)
    state, train_cfg = phase_lm_train(configs, lm_steps)
    phase_lm_mesh(state, train_cfg)
    probe_launches = phase_sparse_probe(svm_path, PathDriver, lipschitz_estimate, ops, K,
                                        sparse_probe, state, train_cfg)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm_train_resume(configs, lm_steps, lm_train)
    phase_lm_mesh_moe(configs, tr)
    gc.collect()
    torch.cuda.empty_cache()
    quickstart_launches = phase_quickstart(quickstart, ops)
    for row in rows:
        row["launches_sparse_probe"] = int(probe_launches.get(row["name"], 0))
        row["launches_quickstart"] = int(quickstart_launches.get(row["name"], 0))

    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    print(json.dumps({"kernels": rows, "not_ported": []}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
