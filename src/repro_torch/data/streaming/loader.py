"""Prefetching shard loader + fixed-slab re-slabber.

Port of ``repro.data.streaming.loader`` (host code only; spans and
instruments go to the port's :mod:`repro_torch.observe`).

:class:`PrefetchLoader` walks a :class:`~repro_torch.data.streaming.sources.ShardedSource`
shard by shard while a background executor keeps a bounded window of
``depth`` reads in flight — the double buffer that overlaps host shard
I/O with device compute. Determinism hooks mirror the rest of the repo:

* ``executor`` — any ``submit()``-shaped pool. Default is an owned
  single worker thread; chaos tests inject :class:`SerialExecutor` so
  reads happen inline at a deterministic point.
* ``clock`` — timestamp function for the shard-read latency histogram.
* ``faults`` — a :class:`repro_torch.distributed.faults.FaultPlan`; each read
  passes through the ``data.prefetch`` site so plans can kill or delay
  a specific shard read (`Preemption` propagates out of ``__iter__``).

Observability: every read runs under a ``data.shard`` span
and, when a ``MetricsRegistry`` is supplied, feeds a
``data.prefetch.depth`` gauge, a ``data.shard.read_s`` histogram and a
``data.rows`` counter.

:class:`ByteAccountant` tracks live host bytes held by the plane
(queue + slab carry) with a high-water mark — the number the
beyond-RAM acceptance test compares against ``source.total_bytes``.

:func:`iter_slabs` re-cuts the shard stream into fixed-size
:class:`Slab` rows-blocks whose boundaries are global row indices, not
shard boundaries. That makes downstream accumulation order a function
of (M, slab_rows) only — bitwise invariant to how the data was
sharded — and lets a resume skip whole shards that precede
``start_row`` without reading them.
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.observe.spans import span

__all__ = ["PrefetchLoader", "SerialExecutor", "ByteAccountant", "Slab",
           "iter_slabs"]


class SerialExecutor:
    """Deterministic drop-in for ``ThreadPoolExecutor``: runs the task
    inline at ``submit()`` time. Chaos tests use it so a ``FaultPlan``
    kill fires at a reproducible point in the shard walk."""

    def submit(self, fn, *args, **kwargs) -> Future:
        fut: Future = Future()
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as exc:   # Preemption must propagate too
            fut.set_exception(exc)
        return fut

    def shutdown(self, wait: bool = True) -> None:
        del wait


class ByteAccountant:
    """Live host-byte ledger with a high-water mark.

    The loader charges each shard when the consumer receives it and
    releases it when the consumer moves past it; ``iter_slabs``
    additionally charges its carry buffer. Reads still in flight on the
    prefetch thread (up to ``depth - 1`` more shards) are not charged,
    so ``peak`` is the most data-plane host memory the consumer ever held
    at once — what the beyond-RAM test asserts stays under the dataset
    size — and the live bytes may lie that many shards higher.
    """

    def __init__(self) -> None:
        self.current = 0
        self.peak = 0

    def hold(self, n_bytes: int) -> None:
        self.current += int(n_bytes)
        if self.current > self.peak:
            self.peak = self.current

    def release(self, n_bytes: int) -> None:
        self.current -= int(n_bytes)
        if self.current < 0:
            raise RuntimeError(
                f"ByteAccountant released more than held ({self.current})")


def _shard_bytes(x: np.ndarray, y: np.ndarray) -> int:
    return int(x.size) * x.dtype.itemsize + int(y.size) * y.dtype.itemsize


class PrefetchLoader:
    """Iterate ``(shard_index, x, y)`` with ≤ ``depth`` reads in flight.

    Iteration is single-use per instance; construct a fresh loader to
    re-walk the source. ``start_shard`` skips earlier shards without
    reading them (resume path).
    """

    def __init__(self, source, *, depth: int = 2, start_shard: int = 0,
                 executor=None, metrics=None, faults=None,
                 clock=time.perf_counter,
                 accountant: ByteAccountant | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.source = source
        self.depth = int(depth)
        self.start_shard = int(start_shard)
        self._owned = executor is None
        self.executor = (ThreadPoolExecutor(max_workers=1)
                         if executor is None else executor)
        self.metrics = metrics
        self.faults = faults
        self.clock = clock
        self.accountant = ByteAccountant() if accountant is None else accountant

    # -- instruments -----------------------------------------------------
    def _gauge(self, value: int) -> None:
        if self.metrics is not None:
            self.metrics.gauge("data.prefetch.depth").set(value)

    def _observe_read(self, seconds: float, rows: int) -> None:
        if self.metrics is not None:
            self.metrics.histogram("data.shard.read_s").observe(seconds)
            self.metrics.counter("data.rows").inc(rows)

    # -- shard read task -------------------------------------------------
    def _read(self, index: int):
        if self.faults is not None:
            self.faults.site("data.prefetch", shard=index)
        t0 = self.clock()
        with span("data.shard", shard=index):
            x, y = self.source.read_shard(index)
            # materialize memmap pages now, on the prefetch thread, so
            # the consumer never blocks on disk
            x = np.ascontiguousarray(x)
            y = np.ascontiguousarray(y)
        self._observe_read(self.clock() - t0, int(y.shape[0]))
        return x, y

    # -- iteration -------------------------------------------------------
    def __iter__(self) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
        n = len(self.source.shard_sizes())
        pending: list[tuple[int, Future]] = []
        nxt = self.start_shard
        try:
            while pending or nxt < n:
                while nxt < n and len(pending) < self.depth:
                    pending.append((nxt, self.executor.submit(self._read, nxt)))
                    nxt += 1
                    self._gauge(len(pending))
                index, fut = pending.pop(0)
                x, y = fut.result()
                self._gauge(len(pending))
                self.accountant.hold(_shard_bytes(x, y))
                try:
                    yield index, x, y
                finally:
                    self.accountant.release(_shard_bytes(x, y))
        finally:
            if self._owned:
                self.executor.shutdown(wait=True)


@dataclass
class Slab:
    """A fixed-size block of the global row stream.

    ``start`` is the global index of row 0; rows ``n_valid:`` are
    zero-padding (zero rows contribute nothing to ODM sums — the same
    convention as ``dsvrg._pad_batches``).
    """
    start: int
    x: np.ndarray
    y: np.ndarray
    n_valid: int


def _check_labels(y: np.ndarray, shard: int) -> None:
    bad = ~np.isin(y, (-1.0, 1.0))
    if bad.any():
        raise ValueError(
            f"shard {shard}: labels must be exactly -1/+1; "
            f"{int(bad.sum())} of {y.shape[0]} rows violate this")


def iter_slabs(source, slab_rows: int, *, start_row: int = 0,
               depth: int = 2, executor=None, metrics=None, faults=None,
               clock=time.perf_counter,
               accountant: ByteAccountant | None = None) -> Iterator[Slab]:
    """Yield :class:`Slab` blocks of exactly ``slab_rows`` rows.

    Slab k covers global rows ``[k * slab_rows, (k+1) * slab_rows)``
    regardless of the source's shard layout; the final slab is
    zero-padded and carries ``n_valid < slab_rows``. ``start_row`` must
    be a slab boundary — shards wholly before it are skipped unread.
    """
    if slab_rows <= 0:
        raise ValueError(f"slab_rows must be positive, got {slab_rows}")
    if start_row % slab_rows:
        raise ValueError(
            f"start_row ({start_row}) must be a multiple of slab_rows "
            f"({slab_rows})")
    sizes = source.shard_sizes()
    M = source.n_rows
    if start_row >= M:
        return
    # first shard that overlaps [start_row, M)
    first, seen = 0, 0
    while first < len(sizes) and seen + sizes[first] <= start_row:
        seen += sizes[first]
        first += 1

    acct = ByteAccountant() if accountant is None else accountant
    loader = PrefetchLoader(source, depth=depth, start_shard=first,
                            executor=executor, metrics=metrics,
                            faults=faults, clock=clock, accountant=acct)
    d = source.n_features
    dtype = np.dtype(source.dtype)
    carry_x = np.zeros((slab_rows, d), dtype=dtype)
    carry_y = np.zeros((slab_rows,), dtype=dtype)
    fill = 0
    pos = start_row            # global row index of the next carry row
    carry_bytes = carry_x.nbytes + carry_y.nbytes
    acct.hold(carry_bytes)
    try:
        for index, x, y in loader:
            _check_labels(np.asarray(y, dtype=np.float64), index)
            shard_lo = seen if index == first else None
            off = start_row - shard_lo if shard_lo is not None else 0
            row = off
            rows = x.shape[0]
            while row < rows:
                take = min(slab_rows - fill, rows - row)
                carry_x[fill:fill + take] = x[row:row + take]
                carry_y[fill:fill + take] = y[row:row + take]
                fill += take
                row += take
                if fill == slab_rows:
                    yield from _emit(acct, pos, carry_x, carry_y, slab_rows)
                    pos += slab_rows
                    fill = 0
            if index == first:
                seen = None    # offset applies only to the first shard
        if fill:
            carry_x[fill:] = 0
            carry_y[fill:] = 0
            yield from _emit(acct, pos, carry_x, carry_y, fill)
    finally:
        acct.release(carry_bytes)


def _emit(acct: ByteAccountant, pos: int, carry_x: np.ndarray,
          carry_y: np.ndarray, n_valid: int) -> Iterator[Slab]:
    """Hand the consumer its OWN copy of the carry buffer.
    ``torch.from_numpy`` zero-copies host numpy, so yielding the reused
    carry directly would let the next slab's fill overwrite rows that a
    CPU computation still reads. The copy is charged to the accountant
    for exactly as long as the consumer holds the yield."""
    sx, sy = carry_x.copy(), carry_y.copy()
    n_bytes = sx.nbytes + sy.nbytes
    acct.hold(n_bytes)
    try:
        yield Slab(pos, sx, sy, n_valid)
    finally:
        acct.release(n_bytes)
