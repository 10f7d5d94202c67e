"""Each kernel's plain version against the reference's Pallas kernel, and
(on a GPU only) each CUDA kernel against its plain version: the margin and
gradient sweeps, the feature screen (its dynamic variant, whose plain
version is held against the reference in test_torch_dynamic.py, and its
EDPP mode, unweighted and weighted, whose plain versions are held against
the reference in test_torch_rules.py) and the sample-surplus sweep.

The reference kernels run as ``tests/test_kernels.py`` runs them on the
CPU: ``interpret=True``. Inputs are identical bits in both packages (bf16
X is rounded once, in torch, and handed over exactly). Both sides
accumulate in fp32 in different orders; tolerance rtol 1e-5 with an
absolute floor of 1e-5 of the output's scale, for fp32 and bf16 X alike
(the bf16 values are the same, only the fp32 sums differ). Rows past
``valid_m`` are zero in X and w, as the compaction contract requires.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.convert import state_from_numpy
from repro_torch.core.dual import lambda_max, theta_at_lambda_max
from repro_torch.core.screening import (
    edpp_scalars,
    edpp_scalars_from_stats,
    feature_reductions,
    shared_scalars,
    shared_scalars_from_stats,
)
from repro_torch.data import make_sparse_classification
from repro_torch.kernels import hinge, screen

SHAPES = [(64, 64), (128, 256), (300, 200), (513, 130)]
DTYPES = [torch.float32, torch.bfloat16]
TOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The reference kernels (JAX). Imported here, not at module level, so
    the card-only test below collects on a machine without JAX."""
    import jax.numpy as jnp
    from repro.kernels import ops

    return SimpleNamespace(jnp=jnp, ops=ops)


def _inputs(m, n, dtype, valid_m, seed):
    ds = make_sparse_classification(m=m, n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    X = torch.from_numpy(ds.X).to(dtype)
    X[valid_m:] = 0
    w = rng.standard_normal(m).astype(np.float32)
    w[valid_m:] = 0
    xi = rng.random(n).astype(np.float32)
    st = state_from_numpy({"w": w, "y": ds.y}, "cpu")
    return X, st["w"], st["y"], torch.from_numpy(xi)


def _to_jax(ref, X):
    return ref.jnp.asarray(X.float().numpy()).astype(
        ref.jnp.bfloat16 if X.dtype == torch.bfloat16 else ref.jnp.float32)


def _close(port, reference):
    reference = np.asarray(reference, np.float64)
    np.testing.assert_allclose(np.asarray(port, np.float64), reference,
                               rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(reference).max())))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_margin_obj_plain_matches_pallas(ref, shape, dtype):
    m, n = shape
    for valid_m in (1, 37, m):
        X, w, y, _ = _inputs(m, n, dtype, valid_m, seed=3)
        b = -0.31
        u, xi, loss = hinge.margin_obj_plain(X, w, y, torch.tensor(b), valid_m)
        u_r, xi_r, loss_r = ref.ops.margin_obj_op(
            _to_jax(ref, X), ref.jnp.asarray(w.numpy()),
            ref.jnp.asarray(y.numpy()), b, block_m=64, block_n=128,
            interpret=True, valid_m=ref.jnp.int32(valid_m))
        _close(u, u_r)
        _close(xi, xi_r)
        _close(float(loss), float(loss_r))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_margin_obj_plain_no_live_rows_matches_pallas(ref, shape, dtype):
    """valid_m = 0: no row is read, even where X's rows are not zero, so
    u = 0 and xi = max(0, 1 - y b), as the Pallas kernel (which skips every
    block) gives."""
    m, n = shape
    X, w, y, _ = _inputs(m, n, dtype, m, seed=12)
    b = 0.29
    u, xi, loss = hinge.margin_obj_plain(X, w, y, torch.tensor(b), 0)
    u_r, xi_r, loss_r = ref.ops.margin_obj_op(
        _to_jax(ref, X), ref.jnp.asarray(w.numpy()),
        ref.jnp.asarray(y.numpy()), b, block_m=64, block_n=128,
        interpret=True, valid_m=ref.jnp.int32(0))
    assert bool((u == 0).all()) and float(np.abs(np.asarray(u_r)).max()) == 0.0
    _close(xi, xi_r)
    _close(float(loss), float(loss_r))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_hinge_grad_plain_matches_pallas(ref, shape, dtype):
    m, n = shape
    for valid_m in (1, 37, m):
        X, _, y, xi = _inputs(m, n, dtype, valid_m, seed=4)
        g = hinge.hinge_grad_plain(X, y, xi, valid_m)
        g_r = ref.ops.hinge_grad_op(
            _to_jax(ref, X), ref.jnp.asarray(y.numpy()),
            ref.jnp.asarray(xi.numpy()), block_m=64, block_n=128,
            interpret=True, valid_m=ref.jnp.int32(valid_m))
        _close(g, g_r)
        assert bool((g[valid_m:] == 0).all())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("delta", [0.0, 0.05])
def test_screen_plain_matches_pallas(ref, shape, dtype, delta):
    """Balanced classes at lambda_max (the Pallas finalizer and ``_t_max``
    agree there; the unbalanced case is held against ``_t_max`` in
    test_torch_screening.py)."""
    m, n = shape
    X, _, y, _ = _inputs(m, n, dtype, m, seed=5)
    lmax = float(lambda_max(X.float(), y))
    theta = theta_at_lambda_max(y, lmax)
    out = screen.screen_bounds_op(X, y, lmax, 0.5 * lmax, theta, delta=delta)
    out_r = ref.ops.screen_bounds_op(
        _to_jax(ref, X), ref.jnp.asarray(y.numpy()), lmax, 0.5 * lmax,
        ref.jnp.asarray(theta.numpy()), block_m=64, block_n=128,
        interpret=True, delta=delta)
    _close(out, out_r)


def test_pack_shared_layout():
    _, _, y, _ = _inputs(64, 64, torch.float32, 64, seed=6)
    theta = torch.abs(y) / 3.0
    sh = shared_scalars(y, 3.0, 2.0, theta, delta=0.1)
    packed = screen.pack_shared(sh)
    assert packed.shape == (screen.NUM_SCALARS,) and packed.dtype == torch.float32
    names = ["inv_lam1", "inv_lam2", "yc", "ysq", "r_h_sq", "g0", "qa_sq",
             "a_norm", "a_dot_y"]
    for i, name in enumerate(names):
        assert float(packed[i]) == float(getattr(sh, name))
    assert float(packed[9]) == float(sh.halfspace_valid)
    assert bool((packed[10:] == 0).all())


def _sample_inputs(m, n, dtype, history, seed):
    """X and y from the generator, a sparse w1 and, with history, u_prev."""
    X, _, y, _ = _inputs(m, n, dtype, m, seed=seed)
    rng = np.random.default_rng(seed + 2)
    w1 = (rng.standard_normal(m) * (rng.random(m) < 0.2)).astype(np.float32)
    u_prev = rng.standard_normal(n).astype(np.float32) if history else None
    st = state_from_numpy({"w1": w1} if u_prev is None else
                          {"w1": w1, "u_prev": u_prev}, "cpu")
    return X, st["w1"], y, st.get("u_prev")


# trust radii: inf (secant only, or nothing without history) and finite
RADII = {"dw_inf": (float("inf"), float("inf")), "dw_finite": (0.37, 0.05)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("history", [False, True], ids=["no_hist", "hist"])
@pytest.mark.parametrize("radii", sorted(RADII))
def test_sample_surplus_plain_matches_pallas(ref, shape, dtype, history, radii):
    """The surplus against the Pallas ``_sample_kernel``; the margins it
    returns against a float64 ``X^T w1 + b1``."""
    m, n = shape
    X, w1, y, u_prev = _sample_inputs(m, n, dtype, history, seed=8)
    dw, db = RADII[radii]
    b1 = -0.23
    surplus, u = screen.sample_surplus_plain(X, w1, y, b1, dw, db, u_prev,
                                             2.0, 1e-3)
    surplus_r = ref.ops.sample_surplus_op(
        _to_jax(ref, X), ref.jnp.asarray(w1.numpy()),
        ref.jnp.asarray(y.numpy()), b1, dw=dw, db=db,
        u_prev=None if u_prev is None else ref.jnp.asarray(u_prev.numpy()),
        shrink_factor=2.0, margin_floor=1e-3, block_m=64, block_n=128,
        interpret=True)
    _close(surplus, surplus_r)
    _close(u, X.double().t().numpy() @ w1.double().numpy() + b1)
    if radii == "dw_inf" and not history:
        assert bool((surplus < 0).all())  # no history, no radius: keep all


def test_pack_sample_scalars_layout(ref):
    from repro.kernels.screen import pack_sample_scalars as ref_pack

    for args in ((-0.3, float("inf"), 0.2, 2.0, 1e-3, True),
                 (0.7, 0.5, float("inf"), 1.5, 0.0, False)):
        packed = screen.pack_sample_scalars(*args)
        assert packed.shape == (screen.NUM_SCALARS,)
        assert packed.dtype == torch.float32
        np.testing.assert_array_equal(packed.numpy(), np.asarray(ref_pack(*args)))


def test_sample_surplus_propagates_nan():
    """A poisoned history gives a NaN surplus (the kernel's mins propagate
    NaN, as torch.minimum does), never a finite score."""
    X, w1, y, u_prev = _sample_inputs(64, 64, torch.float32, True, seed=9)
    u_prev[5] = float("nan")
    surplus, _ = screen.sample_surplus_plain(X, w1, y, 0.1, 0.2, 0.01, u_prev)
    assert torch.isnan(surplus[5]) and bool(torch.isfinite(surplus[6:]).all())


# -- launch plans of the persistent sweeps (pure Python, no card) -----------
PLAN_SHAPES = [(64, 64), (128, 256), (300, 200), (513, 130), (4096, 10000),
               (50000, 10000)]
PLAN_SMS = [114, 132]
ITEMSIZE = {"f32": 4, "bf16": 2}
# base address offsets in bytes: aligned, one fp32 / bf16 item in
OFFSETS = [0, 4, 2]


def _plan_cases():
    for m, n in PLAN_SHAPES:
        for dt, es in ITEMSIZE.items():
            for sms in PLAN_SMS:
                for off in OFFSETS:
                    yield pytest.param(m, n, es, sms, off,
                                       id=f"{m}x{n}-{dt}-sm{sms}-off{off}")


@pytest.mark.parametrize("m,n,itemsize,sms,offset", list(_plan_cases()))
def test_grad_plan_covers_rows_and_columns_once(m, n, itemsize, sms, offset):
    aligned = hinge.rows_aligned(4096 + offset, n, itemsize)
    assert aligned == (offset == 0 and (n * itemsize) % 16 == 0)
    for vm in (m, m // 3, 37 % (m + 1), 1):
        plan = hinge.grad_plan(vm, n, itemsize, aligned, sms)
        assert plan == hinge.grad_plan(vm, n, itemsize, aligned, sms)
        assert plan.bulk == aligned
        assert plan.grid % sms == 0  # whole waves
        rows = [list(plan.rows(b)) for b in range(plan.grid)]
        assert sorted(r for rs in rows for r in rs) == list(range(vm))
        sizes = [len(rs) for rs in rows]
        assert max(sizes) - min(sizes) <= 1  # a tile is one row
        pieces = plan.pieces()
        assert [p for p0, p1 in pieces for p in range(p0, p1)] == list(range(n))
        assert plan.chunk_cols <= hinge.GRAD_V_COLS
        assert 1 <= plan.stages <= hinge.MAX_STAGES
        assert plan.smem_bytes <= hinge.SMEM_PER_BLOCK
        if plan.bulk:  # every copy is whole 16-byte units, at most one stage
            vec = 16 // itemsize
            assert all(p0 % vec == 0 and (p1 - p0) % vec == 0 for p0, p1 in pieces)
            assert max(p1 - p0 for p0, p1 in pieces) * itemsize <= hinge.GRAD_STAGE_BYTES


@pytest.mark.parametrize("m,n,itemsize,sms,offset", list(_plan_cases()))
def test_column_sweep_plan_covers_every_cell_once(m, n, itemsize, sms, offset):
    aligned = hinge.rows_aligned(4096 + offset, n, itemsize)
    plan = hinge.column_sweep_plan(m, n, itemsize, aligned, sms)
    assert plan == hinge.column_sweep_plan(m, n, itemsize, aligned, sms)
    assert plan.bulk == aligned
    assert plan.grid % sms == 0  # whole waves
    owned = [t for b in range(plan.grid) for t in plan.tiles_of(b)]
    assert owned == list(range(plan.tiles))  # each tile in one block, in order
    counts = [len(plan.tiles_of(b)) for b in range(plan.grid)]
    assert max(counts) - min(counts) <= 1
    if plan.grid // math.gcd(plan.grid, plan.segs) <= m // hinge.MAX_STAGE_ROWS:
        assert plan.tiles % plan.grid == 0  # enough rows: equal shares
    # segments x slabs partition the matrix: columns and rows each once
    segs = [plan.tile(c * plan.slabs)[1] for c in range(plan.segs)]
    assert [j for seg in segs for j in seg] == list(range(n))
    slabs = [plan.tile(s)[0] for s in range(plan.slabs)]
    assert [i for sl in slabs for i in sl] == list(range(m))
    assert max(map(len, slabs)) - min(map(len, slabs)) <= 1
    assert all(plan.tile(t) == (slabs[t % plan.slabs], segs[t // plan.slabs])
               for t in range(plan.tiles))
    units = hinge.COLUMN_UNITS if plan.bulk else 1  # 16-byte units a thread
    assert plan.seg_cols * itemsize <= units * 16 * hinge.SWEEP_CONSUMERS
    assert 1 <= plan.stage_rows <= hinge.MAX_STAGE_ROWS
    assert 1 <= plan.stages <= hinge.MAX_STAGES
    assert plan.smem_bytes <= hinge.SMEM_PER_BLOCK
    if plan.bulk:
        assert (plan.seg_cols * itemsize) % 16 == 0
    if m * n <= 300 * 200:  # small shapes: count every cell
        hits = np.zeros((m, n), np.int64)
        for t in range(plan.tiles):
            rows, cols = plan.tile(t)
            hits[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("m,n,itemsize,sms,offset", list(_plan_cases()))
def test_margin_plan_covers_live_rows_once(m, n, itemsize, sms, offset):
    """The margin's column sweep is planned over the live rows alone
    (``column_sweep_plan(valid_m, ...)``): its tiles cover rows
    [0, valid_m) and every column exactly once and reach no row at or past
    valid_m; valid_m = 0 gives tiles of no rows (nothing read, every
    partial 0). The variant follows the rows' alignment; the scratch holds
    one partial row a slab. A repeated call reuses the cached plan (the
    solver asks for it once an iteration)."""
    aligned = hinge.rows_aligned(4096 + offset, n, itemsize)
    for vm in (m, m // 3, 37 % (m + 1), 1, 0):
        plan = hinge.column_sweep_plan(vm, n, itemsize, aligned, sms)
        assert plan is hinge.column_sweep_plan(vm, n, itemsize, aligned, sms)
        assert plan.bulk == aligned and plan.m == vm and plan.n == n
        assert plan.grid % sms == 0  # whole waves
        assert plan.scratch_shape(1) == (plan.slabs, n)
        owned = [t for b in range(plan.grid) for t in plan.tiles_of(b)]
        assert owned == list(range(plan.tiles))  # each tile in one block
        tiles = [plan.tile(t) for t in range(plan.tiles)]
        assert all(rows.stop <= vm for rows, _ in tiles)
        slabs = [plan.tile(s)[0] for s in range(plan.slabs)]
        assert [i for sl in slabs for i in sl] == list(range(vm))
        segs = [plan.tile(c * plan.slabs)[1] for c in range(plan.segs)]
        assert [j for seg in segs for j in seg] == list(range(n))
        assert plan.smem_bytes <= hinge.SMEM_PER_BLOCK
        if vm * n <= 300 * 200:  # small shapes: count every cell
            hits = np.zeros((m, n), np.int64)
            for rows, cols in tiles:
                hits[rows.start:rows.stop, cols.start:cols.stop] += 1
            assert (hits[:vm] == 1).all() and (hits[vm:] == 0).all()


@pytest.mark.parametrize("m,n,itemsize,sms,offset", list(_plan_cases()))
def test_screen_plan_covers_every_cell_once(m, n, itemsize, sms, offset):
    """The feature screen's plan: tiles (a row's column segment) cover every
    (row, column) once, each in one block, the blocks' shares within one
    tile, in whole waves; the staged columns fit the default shared memory;
    the bulk variant loads whole 16-byte units; and the column split is the
    same at m = 1, 2,048 and 50,000, aligned or not, at one n."""
    aligned = hinge.rows_aligned(4096 + offset, n, itemsize)
    plan = screen.screen_plan(m, n, itemsize, aligned, sms)
    assert plan is screen.screen_plan(m, n, itemsize, aligned, sms)
    assert plan.bulk == aligned and (plan.m, plan.n) == (m, n)
    assert plan.grid % sms == 0  # whole waves
    owned = [t for b in range(plan.grid) for t in plan.tiles_of(b)]
    assert owned == list(range(plan.tiles))  # each tile in one block, in order
    counts = [len(plan.tiles_of(b)) for b in range(plan.grid)]
    assert max(counts) - min(counts) <= 1  # the blocks' shares within one tile
    segs = [plan.tile(s * m)[1] for s in range(plan.segs)]
    assert [j for seg in segs for j in seg] == list(range(n))
    if plan.tiles <= 100_000:
        assert all(plan.tile(t) == (t % m, segs[t // m]) for t in range(plan.tiles))
    assert plan.scratch_shape() == (4 * plan.segs, m)
    if n > screen.SCREEN_ROW_COLS:
        assert plan.seg_cols * itemsize <= screen.SCREEN_SEG_BYTES
    else:
        assert plan.segs == 1
    assert plan.smem_bytes <= min(hinge.SMEM_PER_BLOCK, 48 * 1024)  # no opt-in
    if plan.bulk:  # every load is a whole 16-byte unit on a 16-byte boundary
        assert all((seg.start * itemsize) % 16 == 0 and (len(seg) * itemsize) % 16 == 0
                   for seg in segs)
    for other_m in (1, 2048, 50_000):
        for other_aligned in (False, aligned):
            other = screen.screen_plan(other_m, n, itemsize, other_aligned, sms)
            assert (other.seg_cols, other.segs) == (plan.seg_cols, plan.segs)
    if m * n <= 300 * 200:  # small shapes: count every cell
        hits = np.zeros((m, n), np.int64)
        for t in range(plan.tiles):
            row, cols = plan.tile(t)
            hits[row, cols.start:cols.stop] += 1
        assert (hits == 1).all()


def _segment_sums(X, y, theta, weights, plan):
    """A row's four sums as the feature screen adds them: each column
    segment's sums of the plan, then the segments in segment order."""
    w = torch.ones_like(y) if weights is None else weights
    total = None
    for s in range(plan.segs):
        c = plan.tile(s * plan.m)[1]
        xs = X[:, c.start:c.stop].float()
        part = torch.stack([(xs * (y * theta)[c.start:c.stop]).sum(1),
                            (xs * (y * w)[c.start:c.stop]).sum(1),
                            (xs * w[c.start:c.stop]).sum(1),
                            (xs * xs * w[c.start:c.stop]).sum(1)])
        total = part if total is None else total + part
    return total


def test_screen_segment_order_is_the_same_for_chunks():
    """Summed in the plan's segment order, a row's four sums have the same
    bits whether X goes whole or in 2,048-row chunks (the split depends on
    n alone), weighted or not, and they are the plain reductions up to fp32
    rounding (rtol 1e-5)."""
    m, n = 4200, 4400
    rng = np.random.default_rng(51)
    X = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    y = torch.from_numpy(np.where(rng.random(n) < 0.6, 1.0, -1.0).astype(np.float32))
    theta = torch.from_numpy((rng.random(n) / 5.0).astype(np.float32))
    s = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32))
    whole_plan = screen.screen_plan(m, n, 4, True, 132)
    assert whole_plan.segs > 1
    for w in (None, s):
        whole = _segment_sums(X, y, theta, w, whole_plan)
        chunks = torch.cat([_segment_sums(X[i:i + 2048], y, theta, w, screen.screen_plan(
            min(2048, m - i), n, 4, True, 132)) for i in range(0, m, 2048)], dim=1)
        assert torch.equal(whole, chunks)
        _close(whole, torch.stack(list(feature_reductions(X, y, theta, w))))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_bulk_variant_follows_the_tensors_alignment(dtype):
    """Views that start off a 16-byte boundary, or rows whose length is not
    a multiple of 16 bytes, take the scalar variant."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    base = torch.zeros((9, 8 * vec), dtype=dtype)
    assert hinge.bulk_aligned(base) == (base.data_ptr() % 16 == 0)
    odd = torch.zeros((9, 8 * vec + 1), dtype=dtype)
    assert not hinge.bulk_aligned(odd) and not hinge.bulk_aligned(odd[1:])
    assert hinge.bulk_aligned(base[1:]) == hinge.bulk_aligned(base)
    assert not hinge.bulk_aligned(base.view(-1)[1:].view(-1)[: 8 * 8 * vec].view(8, -1))


# card shapes: the ragged ones, the path's width, a 2,048-row chunk of it,
# bf16 n % 8 != 0 with fp32 n % 4 == 0, and rows wider than one staged v
# chunk (aligned and not)
GPU_SHAPES = SHAPES + [(4096, 10000), (2048, 10000), (128, 260), (96, 20000),
                       (40, 20001)]
# where X lies: its own buffer, the view X[1:] of a buffer one row taller
# (aligned when a row is whole 16-byte units), one item past a 16-byte
# boundary (never aligned: the scalar variants)
OFFSETS_CARD = {"base": 0, "view": 1, "item": 2}


def _launched(table, call):
    """(result, variants launched) of one wrapper call."""
    before = dict(table)
    out = call()
    return out, [v for v in table if table[v] > before[v]]


def _on_card(t, offset):
    """``t`` on the card (:data:`OFFSETS_CARD`): ``offset`` 1 as the view
    ``X[1:]`` of a buffer one row taller (its base moves by one row's
    bytes), 2 as a view one item into a flat buffer (its base off every
    16-byte boundary)."""
    if not offset:
        return t.cuda()
    if offset == 2:
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device="cuda")
        flat[1:] = t.cuda().reshape(-1)
        return flat[1:].view(t.shape)
    buf = torch.zeros((t.shape[0] + 1, *t.shape[1:]), dtype=t.dtype, device="cuda")
    buf[1:] = t.cuda()
    return buf[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", list(OFFSETS_CARD.values()), ids=list(OFFSETS_CARD))
def test_cuda_kernels_match_plain(shape, dtype, offset):
    """Card only: each CUDA kernel against its plain version on the same
    device tensors; the margin, the gradient and the feature screen take
    the bulk variant exactly when X's rows are 16-byte aligned and repeat
    their bits, and the margin at valid_m = 0 reads no row (u = 0 over
    nonzero rows). Tolerance rtol 1e-5 (fp32 sums in different orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    m, n = shape
    for valid_m in (1, 37, m):
        X, w, y, xi = _inputs(m, n, dtype, valid_m, seed=7)
        X, w, y, xi = _on_card(X, offset), w.cuda(), y.cuda(), xi.cuda()
        b = torch.tensor(0.21, device="cuda")
        got, launched = _launched(hinge.VARIANTS["margin_obj"],
                                  lambda: hinge.margin_obj_op(X, w, y, b, valid_m))
        assert launched == ["bulk" if hinge.bulk_aligned(X) else "scalar"]
        for g, p in zip(got, hinge.margin_obj_plain(X, w, y, b, valid_m)):
            _close(g.cpu(), p.cpu())
        again = hinge.margin_obj_op(X, w, y, b, valid_m)
        assert all(torch.equal(p, q) for p, q in zip(got, again))
        g, launched = _launched(hinge.VARIANTS["hinge_grad"],
                                lambda: hinge.hinge_grad_op(X, y, xi, valid_m))
        assert launched == ["bulk" if hinge.bulk_aligned(X) else "scalar"]
        _close(g.cpu(), hinge.hinge_grad_plain(X, y, xi, valid_m).cpu())
        assert bool((g[valid_m:] == 0).all())
        assert torch.equal(g, hinge.hinge_grad_op(X, y, xi, valid_m))
    u, xi0, loss = hinge.margin_obj_op(X, w, y, b, 0)  # X's rows are not all 0
    assert bool((u == 0).all())
    for g, p in zip((xi0, loss), hinge.margin_obj_plain(X, w, y, b, 0)[1:]):
        _close(g.cpu(), p.cpu())
    lmax = float(lambda_max(X.float(), y))
    theta = theta_at_lambda_max(y, lmax)
    sh = shared_scalars(y, lmax, 0.5 * lmax, theta, delta=0.02)
    got, launched = _launched(screen.VARIANTS["screen_bounds"],
                              lambda: screen.screen_bounds_from_shared(X, y, theta, sh))
    assert launched == ["bulk" if hinge.bulk_aligned(X) else "scalar"]
    _close(got.cpu(), screen.screen_bounds_plain(X, y, theta, sh).cpu())
    assert torch.equal(got, screen.screen_bounds_from_shared(X, y, theta, sh))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1], ids=["base", "view"])
def test_cuda_sample_surplus_matches_plain(shape, dtype, offset):
    """Card only: the sample-surplus kernel against its plain version, with
    and without history, radii inf and finite, in the variant X's alignment
    allows; a repeated call gives the same bits. Tolerance rtol 1e-5 (fp32
    sums in different orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    m, n = shape
    for history in (False, True):
        X, w1, y, u_prev = _sample_inputs(m, n, dtype, history, seed=10)
        X, w1, y = _on_card(X, offset), w1.cuda(), y.cuda()
        u_prev = None if u_prev is None else u_prev.cuda()
        for dw, db in RADII.values():
            args = (X, w1, y, 0.17, dw, db, u_prev)
            got, launched = _launched(screen.VARIANTS["sample_surplus"],
                                      lambda: screen.sample_surplus_op(*args))
            assert launched == ["bulk" if hinge.bulk_aligned(X) else "scalar"]
            want = screen.sample_surplus_plain(*args)
            for g, p in zip(got, want):
                _close(g.cpu(), p.cpu())
            again = screen.sample_surplus_op(*args)
            assert all(torch.equal(p, q) for p, q in zip(got, again))


def _dynamic_shared(y, lam, theta, delta, weights):
    """The at-lambda region's scalars from the weighted statistics (as
    ``core/solver.py`` ``refresh_bounds`` builds them)."""
    s = torch.ones_like(y) if weights is None else weights
    lam = torch.tensor(lam, device=y.device)
    return shared_scalars_from_stats(
        lam, lam, one_y=torch.sum(y * s), theta_dot_one=torch.sum(theta),
        theta_dot_y=theta @ y, theta_sq=theta @ theta, n_tot=torch.sum(s),
        delta=torch.tensor(delta, device=y.device))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cuda_dynamic_screen_matches_plain(shape, dtype):
    """Card only: the feature screen's dynamic variant against its plain
    version with and without sample weights, the gap-sphere cap on and off,
    each launch counted as ``screen_bounds_dynamic``; a NaN theta gives NaN
    bounds. Tolerance rtol 1e-5 (fp32 sums in different orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    m, n = shape
    X, _, y, _ = _inputs(m, n, dtype, m, seed=24)
    rng = np.random.default_rng(25)
    X, y = X.cuda(), y.cuda()
    s = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).cuda()
    theta = torch.from_numpy((rng.random(n) / 3.0).astype(np.float32)).cuda() * s
    cap = torch.tensor(0.05, device="cuda")
    for w, c in ((s, None), (None, cap), (s, cap)):
        sh = _dynamic_shared(y, 3.0, theta, 0.05, w)
        before = screen.LAUNCHES["screen_bounds_dynamic"]
        got = screen.screen_bounds_from_shared(X, y, theta, sh, w, c)
        assert screen.LAUNCHES["screen_bounds_dynamic"] == before + 1
        _close(got.cpu(), screen.screen_bounds_plain(X, y, theta, sh, w, c).cpu())
    bad = theta.clone()
    bad[n // 2] = float("nan")
    sh = _dynamic_shared(y, 3.0, bad, float("inf"), s)
    inf = torch.tensor(float("inf"), device="cuda")
    assert bool(torch.isnan(screen.screen_bounds_from_shared(X, y, bad, sh, s, inf)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cuda_edpp_screen_matches_plain(shape, dtype):
    """Card only: the feature screen's EDPP mode against its plain version
    (the ``edpp`` rule program over the four reductions) on an exact anchor
    at lam_max with unbalanced classes, an inexact one (delta > 0) and
    alternating (balanced) classes at lam_max
    (v1 = 0 up to rounding, where the fallback gives the VI bound up to
    rounding);
    each launch counted as
    ``screen_bounds_edpp``; the bound is at most the VI mode's on the same
    anchor, bit for bit; a NaN theta gives NaN bounds. Tolerance rtol 1e-5
    (fp32 sums in different orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    m, n = shape
    X, _, y, _ = _inputs(m, n, dtype, m, seed=31)
    X, y = X.cuda(), y.cuda()
    unbalanced = y.clone()
    unbalanced[: n // 5] = 1.0
    balanced = torch.where(torch.arange(n, device="cuda") % 2 == 0, 1.0, -1.0)
    rng = np.random.default_rng(32)
    anchors = ((unbalanced, "exact"), (y, "inexact"), (balanced, "balanced"))
    for yy, kind in anchors:
        lmax = float(lambda_max(X.float(), yy))
        theta = theta_at_lambda_max(yy, lmax)
        lam1, delta = lmax, 0.0
        if kind == "inexact":
            lam1, delta = 0.7 * lmax, 0.02
            theta = torch.from_numpy((rng.random(n) / lam1).astype(np.float32)).cuda()
        sh = shared_scalars(yy, lam1, 0.5 * lam1, theta, delta=delta)
        e = edpp_scalars(yy, lam1, 0.5 * lam1, theta, delta=delta)
        before = screen.LAUNCHES["screen_bounds_edpp"]
        got = screen.screen_bounds_edpp(X, yy, theta, sh, e)
        assert screen.LAUNCHES["screen_bounds_edpp"] == before + 1
        _close(got.cpu(), screen.screen_bounds_edpp_plain(X, yy, theta, sh, e).cpu())
        vi = screen.screen_bounds_from_shared(X, yy, theta, sh)
        assert bool((got <= vi).all())
        if float(e.mu) == 0.0:  # the fallback's DPP ball: VI up to rounding
            _close(got.cpu(), vi.cpu())
    bad = theta.clone()
    bad[n // 2] = float("nan")
    sh = shared_scalars(y, 3.0, 2.0, bad, delta=0.01)
    e = edpp_scalars(y, 3.0, 2.0, bad, delta=0.01)
    assert bool(torch.isnan(screen.screen_bounds_edpp(X, y, bad, sh, e)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cuda_weighted_edpp_screen_matches_plain(shape, dtype):
    """Card only: the feature screen's weighted EDPP mode (the path server's
    sample-masked slots) against its plain version on an inexact anchor and
    on the exact anchor at the live problem's lam_max, each launch counted
    as ``screen_bounds_edpp_weighted``; the bound is at most the weighted
    VI launch's on the same anchor, bit for bit, and a partial launch and
    the EDPP finalize give its bits; a NaN theta gives NaN bounds.
    Tolerance rtol 1e-5 (fp32 sums in different orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    m, n = shape
    X, _, y, _ = _inputs(m, n, dtype, m, seed=33)
    X, y = X.cuda(), y.cuda()
    rng = np.random.default_rng(34)
    s = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).cuda()
    live = s > 0
    lmax = float(lambda_max(X[:, live].float(), y[live]))
    exact = torch.zeros(n, device="cuda")
    exact[live] = theta_at_lambda_max(y[live], lmax)
    inexact = torch.from_numpy((rng.random(n) / (0.7 * lmax)).astype(np.float32)).cuda()
    for theta, lam1, delta in ((exact, lmax, 0.0), (inexact * s, 0.7 * lmax, 0.02),
                               (inexact * s, 0.7 * lmax, float("nan"))):
        if delta != delta:  # the NaN case: a NaN theta
            theta = theta.clone()
            theta[int(torch.nonzero(live)[0])] = float("nan")
            delta = 0.01
        kw = dict(lam1=torch.tensor(lam1, device="cuda"),
                  lam2=torch.tensor(0.5 * lam1, device="cuda"), one_y=y @ s,
                  theta_dot_one=torch.sum(theta), theta_dot_y=theta @ y,
                  theta_sq=theta @ theta, n_tot=torch.sum(s),
                  delta=torch.tensor(delta, device="cuda"))
        sh, e = shared_scalars_from_stats(**kw), edpp_scalars_from_stats(**kw)
        before = screen.LAUNCHES["screen_bounds_edpp_weighted"]
        got = screen.screen_bounds_edpp(X, y, theta, sh, e, weights=s)
        assert screen.LAUNCHES["screen_bounds_edpp_weighted"] == before + 1
        if bool(torch.isnan(theta).any()):
            assert bool(torch.isnan(got).all())
            continue
        _close(got.cpu(), screen.screen_bounds_edpp_plain(X, y, theta, sh, e, s).cpu())
        vi = screen.screen_bounds_from_shared(X, y, theta, sh, weights=s)
        assert bool((got <= vi).all())
        sums = screen.screen_partial_op(X, y, theta, weights=s)
        assert torch.equal(screen.screen_finalize_op(sums, sh, edpp=e), got)
        assert torch.equal(screen.screen_finalize_op(sums, sh), vi)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cuda_screen_variants_agree_bit_for_bit(shape, dtype):
    """Card only: the feature screen sums in the same order in both
    variants, so X in its own buffer (the bulk variant where its rows are
    whole 16-byte units) and X one item off a 16-byte boundary (the scalar
    variant) give the same bits in every mode: VI, dynamic (weights and
    cap), EDPP, weighted EDPP, the d_theta output and the partial sums;
    and a 2,048-row slice of X gives its rows the whole X's bits. Each
    launch counts its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    m, n = shape
    X, _, y, _ = _inputs(m, n, dtype, m, seed=45)
    rng = np.random.default_rng(46)
    y = y.cuda()
    s = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).cuda()
    theta = torch.from_numpy((rng.random(n) / 3.0).astype(np.float32)).cuda()
    sh = shared_scalars(y, 3.0, 2.0, theta, delta=0.02)
    e = edpp_scalars(y, 3.0, 2.0, theta, delta=0.02)
    shd = _dynamic_shared(y, 3.0, theta * s, 0.05, s)
    cap = torch.tensor(0.05, device="cuda")
    calls = {
        "screen_bounds": lambda Xc: screen.screen_bounds_from_shared(
            Xc, y, theta, sh, want_d_theta=True),
        "screen_bounds_dynamic": lambda Xc: (screen.screen_bounds_from_shared(
            Xc, y, theta * s, shd, s, cap),),
        "screen_bounds_edpp": lambda Xc: (screen.screen_bounds_edpp(Xc, y, theta, sh, e),),
        "screen_bounds_edpp_weighted": lambda Xc: (screen.screen_bounds_edpp(
            Xc, y, theta * s, shd, e, weights=s),),
        "screen_partial": lambda Xc: (screen.screen_partial_op(Xc, y, theta, s),),
    }
    Xa, Xs = _on_card(X, 0), _on_card(X, 2)
    assert not hinge.bulk_aligned(Xs)
    for name, call in calls.items():
        a, launched_a = _launched(screen.VARIANTS[name], lambda: call(Xa))
        b, launched_b = _launched(screen.VARIANTS[name], lambda: call(Xs))
        assert launched_a == ["bulk" if hinge.bulk_aligned(Xa) else "scalar"], name
        assert launched_b == ["scalar"], name
        assert all(torch.equal(p, q) for p, q in zip(a, b)), name
        if m > 2048:
            part = call(Xa[1000:1000 + 2048].contiguous())
            assert all(torch.equal(p[..., 1000:1000 + 2048], q)
                       for p, q in zip(a, part)), name


def _d_theta_cases(X, y, n, seed):
    """The feature screen's calls with the optional d_theta output: the VI
    mode on an inexact anchor, and the dynamic variant (sample weights and
    the gap-sphere cap)."""
    rng = np.random.default_rng(seed)
    s = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).to(X.device)
    theta = torch.from_numpy((rng.random(n) / 3.0).astype(np.float32)).to(X.device)
    sh = shared_scalars(y, 3.0, 2.0, theta, delta=0.02)
    cap = torch.tensor(0.05, device=X.device)
    return (("vi", theta, sh, None, None),
            ("dynamic", theta * s, _dynamic_shared(y, 3.0, theta * s, 0.05, s), s, cap))


def test_screen_d_theta_output_plain():
    """On the CPU the d_theta output is the plain reductions' d_theta and
    leaves the bounds as they were."""
    X, _, y, _ = _inputs(130, 70, torch.float32, 130, seed=41)
    for _, theta, sh, w, cap in _d_theta_cases(X, y, 70, seed=42):
        bounds, d_theta = screen.screen_bounds_from_shared(
            X, y, theta, sh, w, cap, want_d_theta=True)
        assert torch.equal(bounds, screen.screen_bounds_from_shared(X, y, theta, sh, w, cap))
        assert torch.equal(d_theta, feature_reductions(X, y, theta, w).d_theta)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cuda_screen_d_theta_output(shape, dtype):
    """Card only: the feature screen's optional d_theta output (VI mode and
    dynamic variant) against the plain ``feature_reductions(...).d_theta``
    (rtol 1e-5: fp32 sums in different orders), with the bounds of the
    launch bit for bit those of the launch without the output, and one
    launch counted each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    m, n = shape
    X, _, y, _ = _inputs(m, n, dtype, m, seed=43)
    X, y = X.cuda(), y.cuda()
    for kind, theta, sh, w, cap in _d_theta_cases(X, y, n, seed=44):
        name = "screen_bounds" if kind == "vi" else "screen_bounds_dynamic"
        before = screen.LAUNCHES[name]
        bounds, d_theta = screen.screen_bounds_from_shared(
            X, y, theta, sh, w, cap, want_d_theta=True)
        assert screen.LAUNCHES[name] == before + 1
        assert torch.equal(bounds, screen.screen_bounds_from_shared(X, y, theta, sh, w, cap))
        _, want = screen.screen_bounds_plain(X, y, theta, sh, w, cap, want_d_theta=True)
        _close(d_theta.cpu(), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1], ids=["base", "view"])
def test_cuda_predicated_launch(dtype, offset):
    """Card only: a launch whose flag is 0 leaves its outputs as they were
    (every block returned before reading X) and counts one skip; with flag
    1 it equals the unpredicated launch bit for bit, and counts none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    m, n = 4096, 10000
    X, w, y, xi = _inputs(m, n, dtype, m, seed=41)
    X, w, y, xi = _on_card(X, offset), w.cuda(), y.cuda(), xi.cuda()
    b = torch.tensor(0.3, device="cuda")
    for valid_m in (m, 37):
        want_u = hinge.margin_obj_op(X, w, y, b, valid_m)
        want_g = hinge.hinge_grad_op(X, y, xi, valid_m)
        for f in (1, 0):
            flag = torch.tensor(f, dtype=torch.int32, device="cuda")
            out = (torch.full((n,), 7.0, device="cuda"), torch.full((n,), 7.0, device="cuda"),
                   torch.full((), 7.0, device="cuda"))
            g = torch.full((m,), 7.0, device="cuda")
            before = hinge.skipped_counts()
            hinge.margin_obj_op(X, w, y, b, valid_m, flag, out=out)
            hinge.hinge_grad_op(X, y, xi, valid_m, flag, out=g)
            skipped = hinge.skipped_counts()
            assert skipped["margin_obj"] - before["margin_obj"] == 1 - f
            assert skipped["hinge_grad"] - before["hinge_grad"] == 1 - f
            if f:
                assert all(torch.equal(p, q) for p, q in zip(out, want_u))
                assert torch.equal(g, want_g)
            else:
                assert all(bool((t == 7.0).all()) for t in (*out, g))


@pytest.mark.gpu
def test_cuda_fista_graph_replay_matches_eager():
    """Card only: ``fista_run`` (its chunks replayed as a CUDA graph, the
    first eager) counts the iterations of the host loop and gives its
    weights bit for bit; a second call replays the cached graph from the
    start and gives the same bits; the restart's sweeps were switched off on
    the iterations without a restart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    from repro_torch.core import solver

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = make_sparse_classification(m=2000, n=400, seed=11)
    X, y = torch.from_numpy(ds.X).cuda(), torch.from_numpy(ds.y).cuda()
    L = float(solver.lipschitz_estimate(X))
    inv_L = float(np.float32(1.0) / max(np.float32(L) * np.float32(1.01), np.float32(1e-12)))
    lam = 0.1 * float(lambda_max(X, y))
    host = solver.fista_solve(X, y, lam, L=L, max_iters=3000)
    hinge.reset_skipped()
    graphs = dict(solver.GRAPHS)
    runs = [solver.fista_run(X, y, lam, torch.zeros(2000, device="cuda"), torch.mean(y),
                             inv_L, max_iters=3000, tol=1e-9) for _ in range(2)]
    assert solver.GRAPHS["replays"] > graphs["replays"]
    for r in runs:
        assert int(r.n_iters) == host.n_iters
        assert torch.equal(r.w, host.w) and float(r.obj) == host.obj
    assert hinge.skipped_counts()["hinge_grad"] > 0


@pytest.mark.gpu
def test_cuda_chunked_stream_matches_in_core():
    """Card only: the out-of-core stream (``repro_torch.sparse``) delivers
    every chunk intact through its pinned double buffer: the streamed
    feature screen equals the in-core kernel launch bit for bit, on dense
    chunks (64 rows, and 2,048 rows of a 4,500 x 4,500 X whose rows span
    three column segments) and on CSR chunks densified on the device (one
    launch per chunk); and the chunked path on the card matches the CPU's at 300
    fixed iterations a step (rel 1e-6, the tolerance of the in-core
    card-vs-CPU check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    from repro_torch.core.path import PathDriver
    from repro_torch.core.screening import screen_bounds
    from repro_torch.core.solver import lipschitz_estimate
    from repro_torch.sparse import FeatureChunked, screen_stream

    torch.backends.cuda.matmul.allow_tf32 = False
    dense = make_sparse_classification(m=300, n=130, seed=21)
    sparse = make_sparse_classification(m=300, n=130, seed=23, density=0.04)
    wide = make_sparse_classification(m=4500, n=4500, seed=25)
    for ds, fc in ((dense, FeatureChunked.from_dense(dense.X, chunk_m=64)),
                   (sparse, FeatureChunked.from_csr(sparse.csr, chunk_m=64)),
                   (wide, FeatureChunked.from_dense(wide.X, chunk_m=2048))):
        X, y = torch.from_numpy(ds.X).cuda(), torch.from_numpy(ds.y).cuda()
        lmax = float(lambda_max(X, y))
        theta = theta_at_lambda_max(y, lmax)
        before = screen.LAUNCHES["screen_bounds"]
        _, got = screen_stream(fc, y, lmax, 0.6 * lmax, theta)
        assert screen.LAUNCHES["screen_bounds"] == before + fc.n_chunks
        assert torch.equal(got, screen_bounds(X, y, lmax, 0.6 * lmax, theta))
    L = float(lipschitz_estimate(torch.from_numpy(dense.X)))
    kw = dict(tol=-1.0, max_iters=300, L=L)
    card = PathDriver(device="cuda", **kw).run(
        FeatureChunked.from_dense(dense.X, chunk_m=64), dense.y)
    cpu = PathDriver(device="cpu", **kw).run(
        FeatureChunked.from_dense(dense.X, chunk_m=64), dense.y)
    np.testing.assert_allclose(card.objectives, cpu.objectives, rtol=1e-6)


# -- partial modes (a sharded run: sums, all-reduce, finalize) ------------------------


def _partial_inputs(m, n, dtype, seed):
    X, w, y, _ = _inputs(m, n, dtype, m, seed)
    g = torch.Generator().manual_seed(seed)
    theta = torch.rand(n, generator=g) / 5.0
    s = (torch.rand(n, generator=g) < 0.7).float()
    u_prev = torch.randn(n, generator=g)
    return X, w, y, theta, s, u_prev


def _partial_calls(X, w, y, theta, s, u_prev, wrap):
    """Each partial mode and its finalize through ``wrap`` (the ops or the
    plain versions), beside the full launch: pairs (full, finalized)."""
    ops = wrap
    sh = shared_scalars(y, 5.0, 3.0, theta, delta=0.01)
    e = edpp_scalars(y, 5.0, 3.0, theta, delta=0.01)
    shd = shared_scalars(y, 4.0, 4.0, theta * s, delta=0.05)
    e_w = edpp_scalars(y, 4.0, 3.0, theta * s, delta=0.05)
    cap = torch.tensor(0.05, device=y.device)
    b = torch.tensor(0.2, device=y.device)
    sums = ops.screen_partial(X, y, theta, None)
    sums_w = ops.screen_partial(X, y, theta * s, s)
    pairs = {
        "margin": (ops.margin_obj(X, w, y, b),
                   ops.margin_finalize(ops.margin_partial(X, w), y, b)),
        "sample": (ops.sample_surplus(X, w, y, 0.13, 0.37, 0.05, u_prev),
                   ops.sample_finalize(ops.sample_partial(X, w), y, 0.13, 0.37, 0.05,
                                       u_prev)),
        "screen": ((ops.screen_full(X, y, theta, sh, None, None),),
                   (ops.screen_finalize(sums, sh, None, None),)),
        "screen_edpp": ((ops.screen_edpp(X, y, theta, sh, e),),
                        (ops.screen_finalize(sums, sh, None, e),)),
        "screen_dynamic": ((ops.screen_full(X, y, theta * s, shd, s, cap),),
                           (ops.screen_finalize(sums_w, shd, cap, None),)),
        "screen_weighted": ((ops.screen_full(X, y, theta * s, shd, s, None),),
                            (ops.screen_finalize(sums_w, shd, None, None),)),
        "screen_edpp_weighted": ((ops.screen_edpp(X, y, theta * s, shd, e_w, s),),
                                 (ops.screen_finalize(sums_w, shd, None, e_w),)),
    }
    return pairs, sums, sums_w


PLAIN = SimpleNamespace(
    margin_obj=hinge.margin_obj_plain, margin_partial=hinge.margin_partial_plain,
    margin_finalize=hinge.margin_finalize_plain,
    sample_surplus=screen.sample_surplus_plain,
    sample_partial=screen.sample_partial_plain,
    sample_finalize=screen.sample_finalize_plain,
    screen_partial=screen.screen_partial_plain,
    screen_finalize=screen.screen_finalize_plain,
    screen_full=screen.screen_bounds_plain, screen_edpp=screen.screen_bounds_edpp_plain)
CARD = SimpleNamespace(
    margin_obj=hinge.margin_obj_op, margin_partial=hinge.margin_partial_op,
    margin_finalize=hinge.margin_finalize_op, sample_surplus=screen.sample_surplus_op,
    sample_partial=screen.sample_partial_op, sample_finalize=screen.sample_finalize_op,
    screen_partial=screen.screen_partial_op, screen_finalize=screen.screen_finalize_op,
    screen_full=screen.screen_bounds_from_shared, screen_edpp=screen.screen_bounds_edpp)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_partial_plain_sums(shape, dtype):
    """The partial modes' plain versions: the margin's ``X^T w`` is
    ``torch.mv``, the screen's four sums are ``feature_reductions`` (weighted
    too), the sample's pair is ``[X^T w, column sums of X * X]``; and a
    partial call followed by its finalize gives the plain full call's bits,
    in every mode (the CPU side of the 1 x 1 contract)."""
    X, w, y, theta, s, u_prev = _partial_inputs(*shape, dtype, seed=11)
    pairs, sums, sums_w = _partial_calls(X, w, y, theta, s, u_prev, PLAIN)
    Xf = X.float()
    torch.testing.assert_close(hinge.margin_partial_plain(X, w), torch.mv(Xf.t(), w),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(sums.numpy(), torch.stack(list(
        feature_reductions(Xf, y, theta))).numpy())
    np.testing.assert_array_equal(sums_w.numpy(), torch.stack(list(
        feature_reductions(Xf, y, theta * s, s))).numpy())
    pair = screen.sample_partial_plain(X, w)
    np.testing.assert_array_equal(pair[0].numpy(), torch.mv(Xf.t(), w).numpy())
    np.testing.assert_array_equal(pair[1].numpy(), torch.sum(Xf * Xf, 0).numpy())
    for name, (full, fin) in pairs.items():
        for a, c in zip(full, fin):
            assert torch.equal(a, c), name


@pytest.mark.parametrize("split", [(2, 2), (4, 1), (1, 4)])
def test_partial_sums_add_up_over_a_split(split):
    """Summed over the blocks of a grid, the partial sums are the whole X's
    (fp32, rtol 1e-5): the screen's over the column blocks of a row block,
    the margin's and the sample's over the row blocks of a column block;
    their finalizes then match the full calls at the same tolerance."""
    M, Dd = split
    m, n = 128, 64
    X, w, y, theta, s, u_prev = _partial_inputs(m, n, torch.float32, seed=13)
    rb, cb = m // M, n // Dd
    sums = torch.cat([sum(screen.screen_partial_plain(
        X[i * rb:(i + 1) * rb, j * cb:(j + 1) * cb], y[j * cb:(j + 1) * cb],
        theta[j * cb:(j + 1) * cb]) for j in range(Dd)) for i in range(M)], dim=1)
    u = torch.cat([sum(hinge.margin_partial_plain(
        X[i * rb:(i + 1) * rb, j * cb:(j + 1) * cb], w[i * rb:(i + 1) * rb])
        for i in range(M)) for j in range(Dd)])
    pair = torch.cat([sum(screen.sample_partial_plain(
        X[i * rb:(i + 1) * rb, j * cb:(j + 1) * cb], w[i * rb:(i + 1) * rb])
        for i in range(M)) for j in range(Dd)], dim=1)
    _close(sums, torch.stack(list(feature_reductions(X, y, theta))))
    _close(u, torch.mv(X.t(), w))
    _close(pair, screen.sample_partial_plain(X, w))
    sh = shared_scalars(y, 5.0, 3.0, theta, delta=0.01)
    _close(screen.screen_finalize_plain(sums, sh), screen.screen_bounds_plain(X, y, theta, sh))
    b = torch.tensor(0.2)
    for a, c in zip(hinge.margin_finalize_plain(u, y, b), hinge.margin_obj_plain(X, w, y, b)):
        _close(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", list(OFFSETS_CARD.values()), ids=list(OFFSETS_CARD))
def test_cuda_partial_modes(shape, dtype, offset):
    """Card only: each partial mode against its plain sums (rtol 1e-5, fp32
    sums in different orders), and a partial launch followed by its
    finalize gives the full launch's bits in every mode (the full launches
    are unchanged with the modes off); each counts its own launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc; runs on the card")
    X, w, y, theta, s, u_prev = _partial_inputs(*shape, dtype, seed=17)
    X = _on_card(X, offset)
    w, y, theta, s, u_prev = (t.cuda() for t in (w, y, theta, s, u_prev))
    before = {**hinge.LAUNCHES, **screen.LAUNCHES}
    pairs, sums, sums_w = _partial_calls(X, w, y, theta, s, u_prev, CARD)
    after = {**hinge.LAUNCHES, **screen.LAUNCHES}
    for name, count in (("margin_partial", 1), ("margin_finalize", 1),
                        ("sample_partial", 1), ("sample_finalize", 1),
                        ("screen_partial", 2), ("screen_finalize", 5)):
        assert after[name] - before[name] == count, name
    _close(sums.cpu(), screen.screen_partial_plain(X, y, theta).cpu())
    _close(sums_w.cpu(), screen.screen_partial_plain(X, y, theta * s, s).cpu())
    _close(hinge.margin_partial_op(X, w).cpu(), hinge.margin_partial_plain(X, w).cpu())
    _close(screen.sample_partial_op(X, w).cpu(), screen.sample_partial_plain(X, w).cpu())
    for name, (full, fin) in pairs.items():
        for a, c in zip(full, fin):
            assert torch.equal(a, c), name
