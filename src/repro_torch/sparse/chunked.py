"""Out-of-core feature-chunked storage of the ``(m, n)`` design matrix.

Port of the reference ``sparse/chunked.py``. Text-like data with ``m >> n``
stops fitting on the card as a dense matrix while every working set still
does: a chunk of feature rows, the rows that survive screening, and the
``(m,)`` and ``(n,)`` vectors. :class:`FeatureChunked` keeps X on the host
as row chunks, each dense (``np.ndarray``) or CSR (:class:`CsrChunk`), and
sends a chunk to the device only while it is swept.

* :meth:`FeatureChunked.stream` is the one transfer point. On the card it
  is a double buffer: two persistent pinned staging buffers, each sized to
  the largest chunk, and a side copy stream. The host copies chunk ``i+1``
  into the free staging buffer (a memmap chunk cannot be pinned in place)
  and enqueues its host-to-device copy on the copy stream while the caller
  computes on chunk ``i``; the caller's stream waits on the copy's event
  before it reads the chunk, and the chunk's device memory is recorded on
  that stream. A staging buffer is refilled only after the event of its
  previous copy has completed. On the CPU a chunk is a host tensor.
* A CSR chunk at density <= :data:`CSR_DENSITY_THRESHOLD` goes to the device
  as its CSR parts (:class:`CsrParts`), so its transfer costs its
  nonzeros; a denser CSR chunk is densified on the host and sent dense.
  On the device a CSR chunk is written densely into one reused
  ``(chunk_m, n)`` buffer per container and device before each product
  (:func:`dense_rows`): cuSPARSE's CSR products are not repeatable bit for
  bit on the card, and the dense ``torch.mv`` on the written rows is.
  (The reference's BCOO route, whose stat ``bcoo_puts`` is ``csr_puts``
  here.)
* :meth:`matvec` / :meth:`rmatvec` are the chunk-accumulated GEMV pair of
  the streamed solver; :meth:`gather_rows` builds the dense host block of
  the rows that survive screening, which the path driver uploads once a
  step, so the device holds ``O(chunk + kept)`` of X, never ``O(m n)``.
* Every streaming entry point takes ``live_chunks=`` (a bool mask or an
  index list): dead chunks are never copied, :meth:`matvec` gives zero rows
  there and :meth:`rmatvec` adds nothing for them.

Disk: :meth:`save_store` / :meth:`from_store` round-trip the container
through a directory of flat binaries read back as ``np.memmap`` views,
with a crc32 per store-grid chunk in ``meta.json``; each grid chunk's
checksum is verified the first time one of its rows is about to reach a
device (or a gathered block), so a corrupt chunk raises
:class:`StoreCorruptError` before its bytes enter any sweep.
:meth:`from_libsvm_cached` builds the store from libsvm text in two
streaming passes and rebuilds it once when opening it fails with a
:class:`StoreError`. Transient read faults retry with backoff
(:func:`_read_with_retry`; ``_read_fault_hook`` is the fault-injection
seam).

``stats`` counts the transfers: ``puts``, ``csr_puts``, ``chunks_streamed``,
``chunks_skipped``, ``bytes_put``, ``max_put_rows`` (the largest row block
ever put on the device) and ``stage_s`` (host seconds spent filling the
staging buffers, the waits for their previous copies included). Every
increment is mirrored into the process metrics registry
(``repro_torch.obs.metrics``) as the counter ``stream.<key>``, and
``max_put_rows`` as the gauge ``stream.max_put_rows``.
"""

from __future__ import annotations

import json
import os
import time
import warnings
import zlib
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..obs import metrics as obs_metrics

__all__ = ["CsrChunk", "CsrParts", "FeatureChunked", "CSR_DENSITY_THRESHOLD",
           "StoreError", "StoreMissingError", "StoreCorruptError",
           "chunk_mv", "chunk_rmv", "dense_rows"]


class StoreError(RuntimeError):
    """Base error for on-disk store problems (missing, corrupt, unreadable)."""


class StoreMissingError(StoreError):
    """The store directory or one of its files does not exist."""


class StoreCorruptError(StoreError):
    """The store exists but fails validation (truncated file, bad meta,
    checksum mismatch)."""


#: Testing seam: when set, called as ``hook(tag, attempt)`` before every
#: guarded store read; raising ``OSError`` simulates a transient I/O fault.
_read_fault_hook = None
_READ_RETRIES = 3
_READ_BACKOFF_S = 0.02


def _read_with_retry(fn, tag: str):
    """Run a store read, retrying a transient ``OSError`` with exponential
    backoff; persistent failure raises :class:`StoreError` naming the read."""
    last = None
    for attempt in range(_READ_RETRIES):
        try:
            if _read_fault_hook is not None:
                _read_fault_hook(tag, attempt)
            return fn()
        except OSError as e:
            last = e
            if attempt + 1 < _READ_RETRIES:
                time.sleep(_READ_BACKOFF_S * (2 ** attempt))
    raise StoreError(
        f"store read failed after {_READ_RETRIES} attempts: {tag}") from last


def _grid_chunk_crc(fmt: str, arrays, s: int, e: int) -> int:
    """crc32 of store-grid rows ``[s, e)``: the payload bytes a sweep of
    those rows would read (CSR: data, indices and the indptr slice)."""
    if fmt == "csr":
        data, indices, indptr = arrays
        lo, hi = int(indptr[s]), int(indptr[e])
        c = zlib.crc32(np.ascontiguousarray(data[lo:hi]).tobytes())
        c = zlib.crc32(np.ascontiguousarray(indices[lo:hi]).tobytes(), c)
        return zlib.crc32(np.ascontiguousarray(indptr[s:e + 1]).tobytes(), c)
    (X,) = arrays
    return zlib.crc32(np.ascontiguousarray(X[s:e]).tobytes())


def _store_grid_checksums(store_dir, meta: dict) -> dict:
    """The ``meta["checksums"]`` block, from the written binaries re-read on
    the store's uniform chunk grid."""
    m = int(meta["m"])
    cm = int(meta["chunk_m"])
    dt = np.dtype(meta["dtype"])
    if meta["format"] == "csr":
        indptr = np.memmap(os.path.join(store_dir, "indptr.bin"),
                           dtype=np.int64, mode="r", shape=(m + 1,))
        nnz = max(int(indptr[-1]), 1)
        arrays = (
            np.memmap(os.path.join(store_dir, "data.bin"), dtype=dt,
                      mode="r", shape=(nnz,)),
            np.memmap(os.path.join(store_dir, "indices.bin"),
                      dtype=np.int32, mode="r", shape=(nnz,)),
            indptr,
        )
    else:
        arrays = (np.memmap(os.path.join(store_dir, "X.bin"), dtype=dt,
                            mode="r", shape=(m, int(meta["n"]))),)
    crcs = [_grid_chunk_crc(meta["format"], arrays, s, min(s + cm, m))
            for s in range(0, m, cm)]
    out = {"algo": "crc32", "chunks": crcs}
    if meta.get("has_y"):
        with open(os.path.join(store_dir, "y.bin"), "rb") as fy:
            out["y"] = zlib.crc32(fy.read())
    return out


def _require_store_file(store_dir, name: str,
                        nbytes: Optional[int] = None) -> str:
    p = os.path.join(store_dir, name)
    if not os.path.exists(p):
        raise StoreMissingError(f"store {store_dir} is missing {name}")
    if nbytes is not None and os.path.getsize(p) < nbytes:
        raise StoreCorruptError(
            f"{p} is truncated: {os.path.getsize(p)} bytes, "
            f"expected at least {nbytes}")
    return p


#: CSR chunks at or below this density travel as their CSR parts (transfer
#: ~ nnz) and are written densely on the device; denser ones are densified
#: on the host per transfer.
CSR_DENSITY_THRESHOLD = 0.05


class CsrChunk(NamedTuple):
    """Host CSR block over a contiguous range of feature rows."""

    data: np.ndarray     # (nnz,)
    indices: np.ndarray  # (nnz,) int32 column (sample) indices
    indptr: np.ndarray   # (rows + 1,) int64, from 0
    n_cols: int

    @property
    def rows(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def density(self) -> float:
        return self.nnz / max(self.rows * self.n_cols, 1)

    def to_dense(self, dtype=None) -> np.ndarray:
        out = np.zeros((self.rows, self.n_cols),
                       dtype=dtype or self.data.dtype)
        rows = np.repeat(np.arange(self.rows), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    def row_sq(self) -> np.ndarray:
        """``||f_j||^2`` per chunk row, from the CSR data (no densify)."""
        sq = self.data.astype(self.data.dtype) ** 2
        out = np.zeros((self.rows,), dtype=self.data.dtype)
        if len(sq):
            rows = np.repeat(np.arange(self.rows), np.diff(self.indptr))
            np.add.at(out, rows, sq)
        return out


class CsrParts(NamedTuple):
    """A CSR chunk on the device: int32 row pointers and column indices,
    the values in the container's dtype, and the container's reused
    ``(chunk_m, n)`` device buffer that :meth:`dense` writes it into."""

    crow: torch.Tensor  # (rows + 1,) int32
    col: torch.Tensor   # (nnz,) int32
    val: torch.Tensor   # (nnz,)
    rows: int
    n: int
    buf: torch.Tensor   # (>= rows, n), shared by the container's chunks

    def dense(self) -> torch.Tensor:
        """The chunk's dense rows, written into the leading rows of ``buf``
        (a row view, contiguous). Each stored value is written once, so the
        result does not depend on the write order."""
        view = self.buf[:self.rows]
        view.zero_()
        counts = (self.crow[1:] - self.crow[:-1]).long()
        rows = torch.repeat_interleave(
            torch.arange(self.rows, device=self.val.device), counts,
            output_size=self.val.shape[0])
        view[rows, self.col.long()] = self.val
        return view


def dense_rows(dev) -> torch.Tensor:
    """A device chunk's ``(rows, n)`` dense rows: the tensor itself, or a
    CSR chunk written into its buffer. Every product of a chunk goes
    through these rows, so a CSR chunking gives the bits of the dense
    chunking of the same matrix; cuSPARSE's CSR products (``torch.mv`` on
    a sparse CSR tensor, ``torch.sparse.mm``) are not repeatable bit for
    bit on the card, which the chunk-skip twin needs."""
    return dev.dense() if isinstance(dev, CsrParts) else dev


def chunk_mv(dev, v: torch.Tensor) -> torch.Tensor:
    """``Xc @ v`` for one device chunk."""
    return torch.mv(dense_rows(dev), v)


def chunk_rmv(dev, w: torch.Tensor) -> torch.Tensor:
    """``Xc^T w`` for one device chunk."""
    return torch.mv(dense_rows(dev).t(), w)


def _as_csr_parts(csr) -> tuple:
    """Duck-typed CSR unpack: scipy ``csr_matrix``, ``data.CsrData``, or a
    plain ``(data, indices, indptr, shape)`` tuple."""
    if hasattr(csr, "indptr") and hasattr(csr, "shape"):
        return (np.asarray(csr.data), np.asarray(csr.indices),
                np.asarray(csr.indptr), tuple(csr.shape))
    data, indices, indptr, shape = csr
    return np.asarray(data), np.asarray(indices), np.asarray(indptr), tuple(shape)


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor over a host array without a copy; a read-only memmap is
    read only here, so torch's warning about it does not apply."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a))


class _Stager:
    """The double buffer of one CUDA device: two pinned staging buffers of
    ``nbytes`` each, the side copy stream, and the event of each buffer's
    last host-to-device copy."""

    _ALIGN = 64  # byte offset of each array in a staging buffer

    def __init__(self, nbytes: int, device: torch.device):
        self.bufs = [torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.events: list = [None, None]
        self.stream = torch.cuda.Stream(device)
        self.device = device
        self.slot = 0

    def put(self, arrays: Sequence[np.ndarray]):
        """Copy ``arrays`` into the free staging buffer and enqueue one
        host-to-device copy of them on the copy stream. Returns the device
        tensors (views of one block allocated on the copy stream), that
        block, and the copy's event."""
        slot, self.slot = self.slot, self.slot ^ 1
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # its previous copy has landed
        buf, off, spans = self.bufs[slot], 0, []
        for a in arrays:
            nb = a.nbytes
            src = _host_tensor(a)
            buf[off:off + nb].view(src.dtype).view(src.shape).copy_(src)
            spans.append((off, nb, src.dtype, src.shape))
            off += -(-nb // self._ALIGN) * self._ALIGN
        with torch.cuda.stream(self.stream):
            block = buf[:off].to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[slot] = ev
        outs = [block[o:o + nb].view(dt).view(shape) for o, nb, dt, shape in spans]
        return outs, block, ev


class FeatureChunked:
    """X as host feature-row chunks, streamed to a device on use.

    Build with :meth:`from_dense`, :meth:`from_csr`, :meth:`from_store` or
    :meth:`from_libsvm_cached`; the constructor takes an explicit chunk
    list (each an ``np.ndarray`` of shape ``(rows_i, n)`` or a
    :class:`CsrChunk`)."""

    def __init__(self, chunks: Sequence[Union[np.ndarray, CsrChunk]], n: int,
                 dtype=np.float32,
                 csr_threshold: float = CSR_DENSITY_THRESHOLD):
        if not chunks:
            raise ValueError("FeatureChunked needs at least one chunk")
        self.chunks = list(chunks)
        self.n = int(n)
        self.dtype = np.dtype(dtype)
        self.torch_dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        self.csr_threshold = float(csr_threshold)
        rows = []
        for c in self.chunks:
            if isinstance(c, CsrChunk):
                if c.n_cols != self.n:
                    raise ValueError(f"chunk n_cols {c.n_cols} != {self.n}")
                rows.append(c.rows)
            else:
                if c.ndim != 2 or c.shape[1] != self.n:
                    raise ValueError(f"bad chunk shape {c.shape}")
                rows.append(c.shape[0])
        self.offsets = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
        self.m = int(self.offsets[-1])
        self.stats = {"puts": 0, "max_put_rows": 0, "csr_puts": 0,
                      "chunks_streamed": 0, "chunks_skipped": 0,
                      "bytes_put": 0, "stage_s": 0.0}
        self.labels = None
        # from_store: lazy checksum state over the store's chunk grid
        self._store = None
        self._stagers: dict = {}   # device -> _Stager
        self._dense_bufs: dict = {}  # device -> the CSR chunks' dense buffer
        self._col_sq: dict = {}    # device -> memoized col_sq

    def _bump(self, key: str, n=1):
        """Increment a ``stats`` counter and mirror it into the metrics
        registry under ``stream.<key>``."""
        self.stats[key] += n
        obs_metrics.counter("stream." + key).inc(n)

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_dense(cls, X, chunk_m: int = 512, **kw) -> "FeatureChunked":
        """Split a dense ``(m, n)`` host matrix into row chunks (numpy views,
        no copy)."""
        X = np.asarray(X)
        m, n = X.shape
        chunk_m = max(int(chunk_m), 1)
        chunks = [X[s: s + chunk_m] for s in range(0, m, chunk_m)]
        return cls(chunks, n, dtype=X.dtype, **kw)

    @classmethod
    def from_csr(cls, csr, chunk_m: int = 512, **kw) -> "FeatureChunked":
        """Split a CSR matrix over feature rows into :class:`CsrChunk` s
        (anything with ``data``/``indices``/``indptr``/``shape``, or a plain
        ``(data, indices, indptr, shape)`` tuple); a row block is an
        ``indptr`` slice."""
        data, indices, indptr, shape = _as_csr_parts(csr)
        m, n = shape
        chunk_m = max(int(chunk_m), 1)
        chunks = []
        for s in range(0, m, chunk_m):
            e = min(s + chunk_m, m)
            lo, hi = indptr[s], indptr[e]
            chunks.append(CsrChunk(
                data=data[lo:hi],
                indices=np.asarray(indices[lo:hi], np.int32),
                indptr=np.asarray(indptr[s: e + 1] - lo, np.int64),
                n_cols=int(n),
            ))
        return cls(chunks, int(n), dtype=data.dtype, **kw)

    # -- shape / metadata --------------------------------------------------

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def chunk_bounds(self, i: int) -> tuple[int, int]:
        return int(self.offsets[i]), int(self.offsets[i + 1])

    def max_chunk_rows(self) -> int:
        return int(np.max(np.diff(self.offsets)))

    def as_dense(self) -> np.ndarray:
        """The full host matrix (for in-core use and small tests)."""
        return np.concatenate([
            c.to_dense(self.dtype) if isinstance(c, CsrChunk)
            else np.asarray(c, self.dtype)
            for c in self.chunks
        ], axis=0)

    # -- device streaming --------------------------------------------------

    def _verify_rows(self, s: int, e: int) -> None:
        """Checksum-verify the store-grid chunks overlapping rows ``[s, e)``
        before those bytes reach any consumer, each grid chunk once per
        container."""
        st = self._store
        if st is None:
            return
        cm = st["chunk_m"]
        for j in range(s // cm, -(-e // cm)):
            if st["verified"][j]:
                continue
            gs, ge = j * cm, min((j + 1) * cm, self.m)
            got = _read_with_retry(
                lambda: _grid_chunk_crc(st["format"], st["arrays"], gs, ge),
                f"{st['dir']} rows [{gs}, {ge})")
            if got != st["crcs"][j]:
                raise StoreCorruptError(
                    f"checksum mismatch in store chunk {j} of {st['dir']} "
                    f"(rows [{gs}, {ge})): expected "
                    f"{st['crcs'][j]:#010x}, got {got:#010x}")
            st["verified"][j] = True

    def verify(self) -> None:
        """Checksum-verify the whole store now (no-op when the container is
        not store-backed)."""
        self._verify_rows(0, self.m)

    def _is_sparse(self, c) -> bool:
        return isinstance(c, CsrChunk) and c.density <= self.csr_threshold

    def _host_form(self, i: int) -> list:
        """The host arrays one chunk is sent as: the CSR parts of a sparse
        chunk (int32 pointers and indices), else the dense rows."""
        c = self.chunks[i]
        if self._is_sparse(c):
            return [c.indptr.astype(np.int32), c.indices.astype(np.int32, copy=False),
                    c.data.astype(self.dtype, copy=False)]
        if isinstance(c, CsrChunk):
            return [c.to_dense(self.dtype)]
        return [np.asarray(c, self.dtype)]

    def _put_bytes(self, i: int) -> int:
        c = self.chunks[i]
        if self._is_sparse(c):
            return (c.rows + 1) * 4 + c.nnz * (4 + self.dtype.itemsize) + 3 * 64
        rows = c.rows if isinstance(c, CsrChunk) else c.shape[0]
        return rows * self.n * self.dtype.itemsize

    def _stager(self, device: torch.device) -> _Stager:
        st = self._stagers.get(device)
        if st is None:
            nbytes = max(self._put_bytes(i) for i in range(self.n_chunks))
            st = self._stagers[device] = _Stager(nbytes, device)
        return st

    def _put(self, i: int, device: torch.device):
        """Start one chunk's transfer: ``(device form, device block,
        copy event)``, the last two ``None`` on the CPU."""
        s, e = self.chunk_bounds(i)
        self._verify_rows(s, e)
        arrays = self._host_form(i)
        self._bump("puts")
        self._bump("chunks_streamed")
        self.stats["max_put_rows"] = max(self.stats["max_put_rows"], e - s)
        obs_metrics.gauge("stream.max_put_rows").set_max(e - s)
        self._bump("bytes_put", sum(a.nbytes for a in arrays))
        block = ev = None
        if device.type == "cuda":
            t0 = time.perf_counter()
            outs, block, ev = self._stager(device).put(arrays)
            self._bump("stage_s", time.perf_counter() - t0)
        else:
            outs = [torch.from_numpy(np.array(a)) for a in arrays]
        if len(outs) == 3:
            self._bump("csr_puts")
            buf = self._dense_bufs.get(device)
            if buf is None:
                buf = self._dense_bufs[device] = torch.empty(
                    (self.max_chunk_rows(), self.n), dtype=self.torch_dtype,
                    device=device)
            return CsrParts(outs[0], outs[1], outs[2], e - s, self.n, buf), block, ev
        return outs[0], block, ev

    @staticmethod
    def _ready(form, block, ev):
        """Make the caller's stream wait for a chunk's copy, and record the
        chunk's device block as used on that stream."""
        if ev is not None:
            compute = torch.cuda.current_stream(block.device)
            compute.wait_event(ev)
            block.record_stream(compute)
        return form

    def live_order(self, live_chunks) -> list:
        """A ``live_chunks`` spec (bool mask over chunks, or index list) as an
        ascending chunk-index list; ``None`` means all live."""
        if live_chunks is None:
            return list(range(self.n_chunks))
        lv = np.asarray(live_chunks)
        if lv.dtype == bool:
            if lv.shape != (self.n_chunks,):
                raise ValueError(
                    f"live_chunks mask shape {lv.shape} != ({self.n_chunks},)")
            return [int(i) for i in np.nonzero(lv)[0]]
        return sorted(int(i) for i in lv)

    def stream(self, device, live_chunks=None):
        """Yield ``(i, device_chunk)`` over the live chunks, with one chunk
        of prefetch: chunk ``i+1``'s transfer starts before chunk ``i`` is
        yielded. A device chunk is a dense ``(rows, n)`` tensor or
        :class:`CsrParts`, ready on the caller's current stream. Dead chunks
        are never transferred (counted in ``chunks_skipped``)."""
        device = torch.device(device)
        order = self.live_order(live_chunks)
        self._bump("chunks_skipped", self.n_chunks - len(order))
        if not order:
            return
        nxt = self._put(order[0], device)
        for j, i in enumerate(order):
            cur = nxt
            if j + 1 < len(order):
                nxt = self._put(order[j + 1], device)
            yield i, self._ready(*cur)

    # -- chunk-accumulated GEMV pair (the solver's two sweeps) -------------

    def matvec(self, v: torch.Tensor, live_chunks=None) -> torch.Tensor:
        """``X @ v`` (m,) on v's device; dead chunks give exact zero rows
        (their weights are certified zero) without a transfer."""
        out = torch.zeros((self.m,), dtype=v.dtype, device=v.device)
        for i, dev in self.stream(v.device, live_chunks):
            s, e = self.chunk_bounds(i)
            out[s:e] = chunk_mv(dev, v)
        return out

    def rmatvec(self, w: torch.Tensor, live_chunks=None) -> torch.Tensor:
        """``X^T w`` (n,), chunk partials accumulated in chunk order; dead
        chunks add nothing (their ``w`` slice is zero)."""
        acc = torch.zeros((self.n,), dtype=w.dtype, device=w.device)
        for i, dev in self.stream(w.device, live_chunks):
            s, e = self.chunk_bounds(i)
            acc = acc + chunk_rmv(dev, w[s:e])
        return acc

    def gram_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``X^T (X v)`` from one stream: each chunk's ``Xc^T (Xc v)`` is its
        own partial, accumulated in chunk order, so the bits are those of
        ``rmatvec(matvec(v))`` at half the transfers (the power iteration's
        sweep)."""
        acc = torch.zeros((self.n,), dtype=v.dtype, device=v.device)
        for _, dev in self.stream(v.device):
            rows = dense_rows(dev)
            acc = acc + torch.mv(rows.t(), torch.mv(rows, v))
        return acc

    def col_sq(self, device) -> torch.Tensor:
        """``||x_i||^2`` per sample (column), memoized per device. CSR chunks
        add their squared data by column on the host (no densify, no
        transfer); dense chunks stream."""
        device = torch.device(device)
        cached = self._col_sq.get(device)
        if cached is not None:
            return cached
        host = np.zeros((self.n,), dtype=self.dtype)
        dense = []
        for i, c in enumerate(self.chunks):
            if isinstance(c, CsrChunk):
                s, e = self.chunk_bounds(i)
                self._verify_rows(s, e)
                if c.nnz:
                    np.add.at(host, c.indices, c.data.astype(self.dtype) ** 2)
            else:
                dense.append(i)
        acc = torch.from_numpy(host).to(device)
        if dense:
            for _, dev in self.stream(device, dense):
                acc = acc + torch.sum(dev * dev, dim=0)
        self._col_sq[device] = acc
        return acc

    def row_sq(self, device) -> torch.Tensor:
        """``||f_j||^2`` for every feature row; CSR chunks from their data
        on the host, dense chunks streamed."""
        device = torch.device(device)
        out = torch.zeros((self.m,), dtype=self.torch_dtype, device=device)
        dense = []
        for i, c in enumerate(self.chunks):
            s, e = self.chunk_bounds(i)
            if isinstance(c, CsrChunk):
                self._verify_rows(s, e)
                out[s:e] = torch.from_numpy(c.row_sq().astype(self.dtype)).to(device)
            else:
                dense.append(i)
        for i, dev in self.stream(device, dense) if dense else ():
            s, e = self.chunk_bounds(i)
            out[s:e] = torch.sum(dev * dev, dim=1)
        return out

    # -- host-side gather (the screened path's reduction) ------------------

    def gather_rows(self, idx: np.ndarray) -> np.ndarray:
        """Dense host block ``(len(idx), n)`` of the given global feature
        rows. Only the chunks holding them are touched (and verified)."""
        idx = np.asarray(idx, np.int64)
        out = np.zeros((len(idx), self.n), dtype=self.dtype)
        which = np.searchsorted(self.offsets[1:], idx, side="right")
        chunk_ids = np.unique(which)
        for ci in chunk_ids:
            self._verify_rows(*self.chunk_bounds(int(ci)))
        for ci in chunk_ids:
            sel = np.nonzero(which == ci)[0]
            local = idx[sel] - self.offsets[ci]
            c = self.chunks[ci]
            if isinstance(c, CsrChunk):
                lo = c.indptr[local]
                counts = c.indptr[local + 1] - lo
                # positions of every stored value of the selected rows
                pos = (np.repeat(lo - np.cumsum(counts) + counts, counts)
                       + np.arange(int(counts.sum())))
                out[np.repeat(sel, counts), c.indices[pos]] = c.data[pos]
            else:
                out[sel] = c[local]
        return out

    # -- disk-resident store (np.memmap-backed chunks) ---------------------

    def save_store(self, store_dir, y=None) -> str:
        """Write this container to an mmap-able store: ``meta.json`` and one
        flat binary per array, ``X.bin`` (dense, row-major) or
        ``data.bin``/``indices.bin``/``indptr.bin`` (CSR over feature rows,
        when every chunk is CSR), chunk by chunk; ``y.bin`` with ``y``.
        ``meta.json`` is written last and marks the store complete."""
        os.makedirs(store_dir, exist_ok=True)
        if all(isinstance(c, CsrChunk) for c in self.chunks):
            running = 0
            indptr_parts = [np.zeros((1,), np.int64)]
            with open(os.path.join(store_dir, "data.bin"), "wb") as fd, \
                    open(os.path.join(store_dir, "indices.bin"), "wb") as fi:
                for c in self.chunks:
                    np.asarray(c.data, self.dtype).tofile(fd)
                    np.asarray(c.indices, np.int32).tofile(fi)
                    indptr_parts.append(
                        np.asarray(c.indptr[1:], np.int64) + running)
                    running += c.nnz
            np.concatenate(indptr_parts).tofile(
                os.path.join(store_dir, "indptr.bin"))
            fmt = "csr"
        else:
            with open(os.path.join(store_dir, "X.bin"), "wb") as fx:
                for c in self.chunks:
                    dense = (c.to_dense(self.dtype) if isinstance(c, CsrChunk)
                             else np.asarray(c, self.dtype))
                    dense.tofile(fx)
            fmt = "dense"
        if y is not None:
            np.asarray(y, self.dtype).tofile(os.path.join(store_dir, "y.bin"))
        meta = {"format": fmt, "m": self.m, "n": self.n,
                "dtype": self.dtype.name, "chunk_m": self.max_chunk_rows(),
                "has_y": y is not None}
        meta["checksums"] = _store_grid_checksums(store_dir, meta)
        with open(os.path.join(store_dir, "meta.json"), "w") as fm:
            json.dump(meta, fm)
        return str(store_dir)

    @classmethod
    def from_store(cls, store_dir, chunk_m: Optional[int] = None,
                   **kw) -> "FeatureChunked":
        """Open a store with ``np.memmap``-backed chunks (views: nothing is
        read until a chunk is used). ``chunk_m`` re-slices the stored
        chunking. Labels saved alongside are ``.labels`` (else ``None``).

        Raises :class:`StoreMissingError` for an absent directory or file,
        :class:`StoreCorruptError` for unreadable meta or a file shorter
        than meta implies; each grid chunk's crc32 is verified on first use
        (:meth:`verify` does all of them now)."""
        if not os.path.isdir(store_dir):
            raise StoreMissingError(f"no such store directory: {store_dir}")
        meta_path = _require_store_file(store_dir, "meta.json")
        try:
            with open(meta_path) as fm:
                meta = json.load(fm)
            m, n = int(meta["m"]), int(meta["n"])
            dtype = np.dtype(meta["dtype"])
            fmt = meta["format"]
        except (ValueError, KeyError, TypeError) as e:
            raise StoreCorruptError(
                f"unreadable store meta {meta_path}: {e}") from e
        chunk_m = int(chunk_m or meta["chunk_m"])
        if fmt == "csr":
            _require_store_file(store_dir, "indptr.bin", (m + 1) * 8)
            indptr = np.memmap(os.path.join(store_dir, "indptr.bin"),
                               dtype=np.int64, mode="r", shape=(m + 1,))
            nnz = int(_read_with_retry(lambda: indptr[-1],
                                       f"{store_dir}/indptr.bin"))
            _require_store_file(store_dir, "data.bin", nnz * dtype.itemsize)
            _require_store_file(store_dir, "indices.bin", nnz * 4)
            data = np.memmap(os.path.join(store_dir, "data.bin"),
                             dtype=dtype, mode="r")
            indices = np.memmap(os.path.join(store_dir, "indices.bin"),
                                dtype=np.int32, mode="r")
            fc = cls.from_csr((data, indices, indptr, (m, n)),
                              chunk_m=chunk_m, **kw)
            arrays = (data, indices, indptr)
        else:
            _require_store_file(store_dir, "X.bin", m * n * dtype.itemsize)
            X = np.memmap(os.path.join(store_dir, "X.bin"), dtype=dtype,
                          mode="r", shape=(m, n))
            fc = cls.from_dense(X, chunk_m=chunk_m, **kw)
            arrays = (X,)
        sums = meta.get("checksums")
        if sums and sums.get("algo") == "crc32":
            grid_cm = int(meta["chunk_m"])
            n_grid = -(-m // grid_cm)
            crcs = list(sums["chunks"])
            if len(crcs) != n_grid:
                raise StoreCorruptError(
                    f"store {store_dir}: manifest has {len(crcs)} chunk "
                    f"checksums, grid has {n_grid}")
            fc._store = {"dir": str(store_dir), "format": fmt,
                         "arrays": arrays, "chunk_m": grid_cm,
                         "crcs": crcs,
                         "verified": np.zeros((n_grid,), dtype=bool)}
        y_path = os.path.join(store_dir, "y.bin")
        if meta.get("has_y") and os.path.exists(y_path):
            def read_y():
                with open(y_path, "rb") as fy:
                    return fy.read()
            raw = _read_with_retry(read_y, y_path)
            if sums and "y" in sums and zlib.crc32(raw) != sums["y"]:
                raise StoreCorruptError(
                    f"checksum mismatch in {y_path}: labels are corrupt")
            fc.labels = np.frombuffer(raw, dtype=dtype).copy()
        return fc

    @classmethod
    def from_libsvm_cached(cls, path, store_dir=None, chunk_m: int = 512,
                           dtype=np.float32, n_features: Optional[int] = None,
                           zero_based: bool = False, rebuild: bool = False,
                           **kw) -> tuple:
        """Libsvm text -> on-disk CSR store (built once) -> memmap container.

        Returns ``(FeatureChunked, y)``. The store is built in two streaming
        passes over the text (counts per feature row, then a scatter into
        preallocated memmaps), so the dense matrix never exists in host
        RAM; it sits beside the text as ``<path>.store/`` unless
        ``store_dir`` is given, and later calls reopen it (``rebuild=True``
        forces a build). A store that fails to open or verify
        (:class:`StoreError`) is rebuilt from the text once; the error
        propagates when the rebuild fails too."""
        from ..data.svm import iter_libsvm

        store_dir = str(store_dir or f"{path}.store")
        if rebuild or not os.path.exists(os.path.join(store_dir, "meta.json")):
            os.makedirs(store_dir, exist_ok=True)
            # pass 1: labels and nonzeros per feature row
            counts = np.zeros((1024,), np.int64)
            labels = []
            for label, idx, _ in iter_libsvm(path, zero_based=zero_based):
                labels.append(label)
                if idx:
                    top = max(idx)
                    while top >= len(counts):
                        counts = np.concatenate([counts, np.zeros_like(counts)])
                    np.add.at(counts, idx, 1)
            n = len(labels)
            if n == 0:
                raise ValueError(f"no samples in {path}")
            seen_m = int(np.max(np.nonzero(counts)[0])) + 1 if counts.any() else 0
            m = int(n_features) if n_features else seen_m
            if seen_m > m:
                raise ValueError(
                    f"feature index {seen_m - 1} >= n_features={m}")
            counts = counts[:m]
            indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            nnz = int(indptr[-1])
            dt = np.dtype(dtype)
            data = np.memmap(os.path.join(store_dir, "data.bin"), dtype=dt,
                             mode="w+", shape=(max(nnz, 1),))
            indices = np.memmap(os.path.join(store_dir, "indices.bin"),
                                dtype=np.int32, mode="w+",
                                shape=(max(nnz, 1),))
            # pass 2: each sample's entries at its rows' fill fronts
            fill = indptr[:-1].copy()
            for col, (_, idx, vals) in enumerate(
                    iter_libsvm(path, zero_based=zero_based)):
                if not idx:
                    continue
                jj = np.asarray(idx, np.int64)
                pos = fill[jj]
                data[pos] = np.asarray(vals, dt)
                indices[pos] = col
                fill[jj] += 1
            data.flush()
            indices.flush()
            del data, indices
            indptr.tofile(os.path.join(store_dir, "indptr.bin"))
            y = np.where(np.asarray(labels) > 0, 1.0, -1.0).astype(dt)
            y.tofile(os.path.join(store_dir, "y.bin"))
            meta = {"format": "csr", "m": m, "n": n, "dtype": dt.name,
                    "chunk_m": int(chunk_m), "has_y": True}
            meta["checksums"] = _store_grid_checksums(store_dir, meta)
            with open(os.path.join(store_dir, "meta.json"), "w") as fm:
                json.dump(meta, fm)
        try:
            fc = cls.from_store(store_dir, chunk_m=chunk_m, **kw)
            # verify now: corruption must trigger the rebuild here, not a
            # StoreCorruptError in the middle of a path
            fc.verify()
        except StoreError:
            if rebuild or not os.path.exists(path):
                raise  # built just now, or no text to rebuild from
            return cls.from_libsvm_cached(
                path, store_dir=store_dir, chunk_m=chunk_m, dtype=dtype,
                n_features=n_features, zero_based=zero_based, rebuild=True,
                **kw)
        return fc, fc.labels

