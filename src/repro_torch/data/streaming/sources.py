"""Sharded data sources — the supply side of the streaming data plane.

A copy of the numpy-only ``repro.data.streaming.sources`` (the port
imports nothing of ``repro``), so the same arguments give the same shard
bytes in both packages, ``SyntheticSource`` included.

A :class:`ShardedSource` is anything that can hand back shard ``i`` of a
(M, d) training set as host numpy arrays without ever materializing the
whole matrix: the loader (:mod:`repro_torch.data.streaming.loader`) pulls
shards through a bounded prefetch queue, the one-pass partitioner
(:mod:`repro_torch.data.streaming.plan`) sketches them, and the streaming
solver drivers (``core.dsvrg._solve_stream`` /
``core.baselines._cascade_solve_stream``) consume them slab by slab.

Four concrete sources cover the supported storage shapes:

* :class:`ArraySource` — in-memory arrays presented as shards. The
  "same data presented the other way" half of every streaming-vs-
  in-memory parity test, and the zero-setup path for small jobs.
* :class:`NpyShardSource` — one ``.npy`` pair per shard, opened with
  ``np.load(mmap_mode="r")`` so a read touches only that shard's pages.
  :meth:`NpyShardSource.write` lays a dataset out in this format.
* :class:`RawBinarySource` — headerless binary (the LIBSVM-converted
  dump format), one features + one labels file per shard via
  ``np.memmap``; ``n_features``/``dtype`` come from the caller.
* :class:`SyntheticSource` — generates shard ``i`` on the fly from a
  seed (no disk at all): two blob classes separated along a zero-mean
  direction, shard-deterministic, so tests and benches can stream
  "datasets" orders of magnitude larger than host RAM.

Every source counts per-shard reads (``source.reads``) — the resume
tests assert completed shards are *not* re-read — and fingerprints
itself (:meth:`fingerprint`) for the resume provenance check.
"""
from __future__ import annotations

import os
from typing import Iterable, Protocol, runtime_checkable

import numpy as np

__all__ = ["ShardedSource", "ArraySource", "NpyShardSource",
           "RawBinarySource", "SyntheticSource", "is_source",
           "materialize"]


@runtime_checkable
class ShardedSource(Protocol):
    """Structural protocol every source implements (and ducks satisfy)."""

    n_rows: int
    n_features: int

    def shard_sizes(self) -> tuple[int, ...]:
        """Rows per shard; sums to ``n_rows``."""
        ...

    def read_shard(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        """Shard ``index`` as host arrays ``(x (rows, d), y (rows,))``."""
        ...

    def fingerprint(self) -> dict:
        """JSON-able identity for resume provenance."""
        ...


def is_source(obj) -> bool:
    """Duck check used by ``ODMEstimator.fit`` to detect a source in the
    ``x`` slot (arrays have ``shape``; sources have ``read_shard``)."""
    return (hasattr(obj, "read_shard") and hasattr(obj, "shard_sizes")
            and hasattr(obj, "n_rows"))


class _SourceBase:
    """Shared bookkeeping: read counters, byte math, iteration."""

    n_rows: int
    n_features: int
    dtype: np.dtype

    def _init_counts(self, sizes: tuple[int, ...]) -> None:
        self._sizes = tuple(int(s) for s in sizes)
        if any(s <= 0 for s in self._sizes):
            raise ValueError(f"every shard needs >= 1 row, got {self._sizes}")
        self.n_rows = sum(self._sizes)
        #: per-shard read counts — chaos tests assert completed shards
        #: are not re-read after a resume
        self.reads = [0] * len(self._sizes)

    @property
    def n_shards(self) -> int:
        return len(self._sizes)

    def shard_sizes(self) -> tuple[int, ...]:
        return self._sizes

    @property
    def total_bytes(self) -> int:
        """Feature + label bytes of the full dataset (the beyond-RAM
        budget tests compare the loader's peak against this)."""
        item = np.dtype(self.dtype).itemsize
        return self.n_rows * (self.n_features + 1) * item

    def read_shard(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        if not 0 <= index < self.n_shards:
            raise IndexError(
                f"shard {index} out of range [0, {self.n_shards})")
        self.reads[index] += 1
        x, y = self._read(index)
        if x.shape != (self._sizes[index], self.n_features):
            raise ValueError(
                f"shard {index}: expected x {(self._sizes[index], self.n_features)}, "
                f"got {x.shape}")
        if y.shape != (self._sizes[index],):
            raise ValueError(
                f"shard {index}: expected y ({self._sizes[index]},), got "
                f"{y.shape}")
        return x, y

    def _read(self, index: int):   # pragma: no cover - abstract
        raise NotImplementedError


def materialize(source: ShardedSource) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate every shard (tests / small jobs only — this is exactly
    the global load the streaming plane exists to avoid)."""
    xs, ys = zip(*(source.read_shard(i)
                   for i in range(len(source.shard_sizes()))))
    return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)


class ArraySource(_SourceBase):
    """In-memory arrays presented through the source protocol.

    ``shard_rows=None`` presents the whole set as one shard; otherwise
    contiguous row blocks of ``shard_rows`` (ragged tail allowed).
    Shards are views — no copy until the loader materializes one.
    """

    def __init__(self, x, y, shard_rows: int | None = None):
        x = np.asarray(x)
        y = np.asarray(y)
        if x.ndim != 2 or y.ndim != 1 or x.shape[0] != y.shape[0]:
            raise ValueError(
                f"need x (M, d) and y (M,), got {x.shape} / {y.shape}")
        self._x, self._y = x, y
        self.n_features = int(x.shape[1])
        self.dtype = x.dtype
        M = int(x.shape[0])
        rows = M if shard_rows is None else int(shard_rows)
        if rows <= 0:
            raise ValueError(f"shard_rows must be positive, got {rows}")
        sizes = [rows] * (M // rows)
        if M % rows:
            sizes.append(M % rows)
        self._init_counts(tuple(sizes))
        self._starts = np.concatenate([[0], np.cumsum(self._sizes)])

    def _read(self, index: int):
        lo, hi = self._starts[index], self._starts[index + 1]
        return self._x[lo:hi], self._y[lo:hi]

    def fingerprint(self) -> dict:
        return {
            "kind": "array",
            "shape": [self.n_rows, self.n_features],
            "dtype": str(self.dtype),
            "shards": list(self._sizes),
            "x_sum": float(np.sum(self._x, dtype=np.float64)),
            "y_sum": float(np.sum(self._y, dtype=np.float64)),
        }


class NpyShardSource(_SourceBase):
    """Memory-mapped ``.npy`` shard pairs.

    ``pairs`` is a sequence of ``(x_path, y_path)``. Headers are parsed
    eagerly (cheap) for sizes/dtype; row data is paged in lazily by the
    OS on read, so the resident set stays bounded by what the loader
    holds, not by the dataset.
    """

    def __init__(self, pairs: Iterable[tuple[str, str]]):
        self.pairs = [(os.fspath(a), os.fspath(b)) for a, b in pairs]
        if not self.pairs:
            raise ValueError("NpyShardSource needs >= 1 shard pair")
        sizes = []
        d = dtype = None
        for xp, yp in self.pairs:
            xm = np.load(xp, mmap_mode="r")
            ym = np.load(yp, mmap_mode="r")
            if xm.ndim != 2 or ym.ndim != 1 or xm.shape[0] != ym.shape[0]:
                raise ValueError(
                    f"shard {xp!r}/{yp!r}: need (rows, d) + (rows,), got "
                    f"{xm.shape} / {ym.shape}")
            if d is None:
                d, dtype = int(xm.shape[1]), xm.dtype
            elif int(xm.shape[1]) != d:
                raise ValueError(
                    f"shard {xp!r} has d={xm.shape[1]}, first shard had {d}")
            sizes.append(int(xm.shape[0]))
        self.n_features = d
        self.dtype = dtype
        self._init_counts(tuple(sizes))

    def _read(self, index: int):
        xp, yp = self.pairs[index]
        return (np.load(xp, mmap_mode="r"), np.load(yp, mmap_mode="r"))

    def fingerprint(self) -> dict:
        return {
            "kind": "npy",
            "paths": [list(p) for p in self.pairs],
            "shards": list(self._sizes),
            "d": self.n_features,
            "dtype": str(self.dtype),
        }

    @staticmethod
    def write(directory: str, x, y, shard_rows: int) -> "NpyShardSource":
        """Lay ``(x, y)`` out as npy shards under ``directory``."""
        x = np.asarray(x)
        y = np.asarray(y)
        os.makedirs(directory, exist_ok=True)
        pairs = []
        for s, lo in enumerate(range(0, x.shape[0], int(shard_rows))):
            hi = min(lo + int(shard_rows), x.shape[0])
            xp = os.path.join(directory, f"shard_{s:05d}_x.npy")
            yp = os.path.join(directory, f"shard_{s:05d}_y.npy")
            np.save(xp, x[lo:hi])
            np.save(yp, y[lo:hi])
            pairs.append((xp, yp))
        return NpyShardSource(pairs)


class RawBinarySource(_SourceBase):
    """Headerless binary shard pairs via ``np.memmap``.

    Each pair is ``(x_path, y_path)`` holding ``rows * n_features`` and
    ``rows`` items of ``dtype`` respectively; ``rows`` is inferred from
    the label file size.
    """

    def __init__(self, pairs: Iterable[tuple[str, str]], n_features: int,
                 dtype=np.float32):
        self.pairs = [(os.fspath(a), os.fspath(b)) for a, b in pairs]
        if not self.pairs:
            raise ValueError("RawBinarySource needs >= 1 shard pair")
        if n_features <= 0:
            raise ValueError(f"n_features must be positive, got {n_features}")
        self.n_features = int(n_features)
        self.dtype = np.dtype(dtype)
        item = self.dtype.itemsize
        sizes = []
        for xp, yp in self.pairs:
            rows, rem = divmod(os.path.getsize(yp), item)
            if rem:
                raise ValueError(
                    f"label file {yp!r} is not a whole number of "
                    f"{self.dtype} items")
            want = rows * self.n_features * item
            if os.path.getsize(xp) != want:
                raise ValueError(
                    f"feature file {xp!r} holds {os.path.getsize(xp)} bytes, "
                    f"expected {want} ({rows} rows x {self.n_features})")
            sizes.append(int(rows))
        self._init_counts(tuple(sizes))

    def _read(self, index: int):
        xp, yp = self.pairs[index]
        rows = self._sizes[index]
        x = np.memmap(xp, dtype=self.dtype, mode="r",
                      shape=(rows, self.n_features))
        y = np.memmap(yp, dtype=self.dtype, mode="r", shape=(rows,))
        return x, y

    def fingerprint(self) -> dict:
        return {
            "kind": "raw",
            "paths": [list(p) for p in self.pairs],
            "shards": list(self._sizes),
            "d": self.n_features,
            "dtype": str(self.dtype),
        }


class SyntheticSource(_SourceBase):
    """On-the-fly generator source: shard ``i`` is a pure function of
    ``(seed, i)``, so an arbitrarily large "dataset" occupies zero disk
    and exactly one shard of host memory at a time.

    Construction follows the blobs of :mod:`repro_torch.data.synthetic`
    where it matters for the linear route: ±1 labels at ``balance``, features
    ``0.5 + noise + y * sep * u`` with ``u`` a zero-mean unit direction
    (the data midpoint sits on the all-ones shift, which a bias-free
    linear ODM cannot represent — a zero-mean boundary normal keeps the
    problem homogeneous-separable). Unlike ``synthetic.load`` there is no
    global normalization pass: every statistic is shard-local and
    deterministic, which is what makes single-scan streaming exact.
    """

    def __init__(self, n_rows: int, n_features: int, shard_rows: int,
                 seed: int = 0, sep: float = 1.0, balance: float = 0.5,
                 noise: float = 0.15, dtype=np.float32):
        if n_rows <= 0 or n_features <= 0 or shard_rows <= 0:
            raise ValueError(
                f"n_rows/n_features/shard_rows must be positive, got "
                f"{n_rows}/{n_features}/{shard_rows}")
        self.n_features = int(n_features)
        self.dtype = np.dtype(dtype)
        self.seed = int(seed)
        self.sep = float(sep)
        self.balance = float(balance)
        self.noise = float(noise)
        n_rows, shard_rows = int(n_rows), int(shard_rows)
        sizes = [shard_rows] * (n_rows // shard_rows)
        if n_rows % shard_rows:
            sizes.append(n_rows % shard_rows)
        self._init_counts(tuple(sizes))
        # class direction: shared across shards, derived from seed only
        rng = np.random.default_rng([self.seed, 0x0D1])
        u = rng.standard_normal(self.n_features)
        u = u - u.mean()
        self._u = (u / np.linalg.norm(u)).astype(self.dtype)

    def _read(self, index: int):
        rows = self._sizes[index]
        rng = np.random.default_rng([self.seed, 1 + index])
        y = np.where(rng.random(rows) < self.balance, 1.0, -1.0)
        z = rng.standard_normal((rows, self.n_features))
        x = 0.5 + self.noise * (z + (self.sep * y)[:, None] * self._u)
        return x.astype(self.dtype), y.astype(self.dtype)

    def fingerprint(self) -> dict:
        return {
            "kind": "synthetic",
            "n_rows": self.n_rows,
            "d": self.n_features,
            "shards": list(self._sizes),
            "seed": self.seed,
            "sep": self.sep,
            "balance": self.balance,
            "noise": self.noise,
            "dtype": str(self.dtype),
        }
