"""One-pass streaming partitioner: Eqn. 8 landmarks + Eqn. 7 strata
from a single scan over shards, with no global materialization.

Port of ``repro.data.streaming.plan``. Dense
:mod:`repro_torch.core.partition` needs the whole (M, d) matrix twice:
once for greedy det-max landmark selection (Eqn. 8, pivoted Cholesky
over all rows) and once for stratum assignment (Eqn. 7 argmin RKHS
distance). The streaming versions replace each global pass:

* **Landmarks** — :func:`sketch_landmarks` maintains an Algorithm-R
  reservoir while the shards stream by (numpy's generator, so the sample
  equals the reference's row for row), then runs the *exact* pivoted
  Cholesky greedy selection of ``partition.select_landmarks`` on the
  reservoir, on the device the caller names. When ``reservoir >=
  n_rows`` the reservoir IS the stream in order, so the selected
  landmark set matches the dense Eqn. 8 result on the same data exactly.
* **Strata + partitions** — :class:`StreamingAssigner` assigns each
  arriving row its stratum (the argmin-distance formula of
  ``partition.assign_strata``, through ``core.kernel_fns`` on the
  landmarks' device) and then a partition by per-stratum round-robin
  over running counts. Assignment is integer-exact and depends only on
  each row's global position within its stratum, never on shard
  boundaries — the same data sharded two ways gets bitwise identical
  partition labels.

:func:`streaming_plan` glues both into one scan: pass 1 sketches the
landmarks, after which assignment is a pure per-row function applied
shard-locally as the solver streams the data.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import kernel_fns as kf
from repro_torch.core import partition as partition_mod
from repro_torch.kernels._device import resolve_device

Tensor = torch.Tensor

__all__ = ["reservoir_sample", "sketch_landmarks", "assign_strata_values",
           "StreamingAssigner", "StreamingPlan", "streaming_plan"]


def reservoir_sample(source, k: int, *, seed: int = 0,
                     loader=None) -> np.ndarray:
    """Uniform row sample of size ``min(k, n_rows)`` in one scan
    (Algorithm R, deterministic in ``seed`` and the stream order; the
    reference's generator and draws, so the same rows).

    Returns the sampled rows as a dense ``(s, d)`` host array. When
    ``k >= n_rows`` this degenerates to the stream itself in order.
    """
    if k <= 0:
        raise ValueError(f"reservoir size must be positive, got {k}")
    rng = np.random.default_rng([int(seed), 0x5EED])
    res = np.zeros((min(k, source.n_rows), source.n_features),
                   dtype=source.dtype)
    filled = 0      # rows placed so far while the reservoir fills
    seen = 0        # total rows seen
    shards = (loader if loader is not None else
              ((i, *source.read_shard(i))
               for i in range(len(source.shard_sizes()))))
    for _, x, _ in shards:
        for row in np.asarray(x):
            if filled < res.shape[0]:
                res[filled] = row
                filled += 1
            else:
                j = rng.integers(0, seen + 1)
                if j < res.shape[0]:
                    res[j] = row
            seen += 1
    return res


def sketch_landmarks(spec: kf.KernelSpec, source, n_landmarks: int, *,
                     reservoir: int = 4096, seed: int = 0,
                     jitter: float = 1e-6, loader=None,
                     device: str | torch.device | None = None) -> Tensor:
    """Eqn. 8 landmark *values* ``(n_landmarks, d)`` from one scan, on
    ``device`` (``None``: the card; with no card this raises and names
    ``device="cpu"``).

    Reservoir-sample ``reservoir`` rows, then run the exact greedy
    det-max (pivoted Cholesky) of
    :func:`repro_torch.core.partition.select_landmarks` on the sample.
    Dense selection returns row *indices*; a stream has no stable global
    index to hand back, so this returns the landmark rows themselves.
    """
    if reservoir < n_landmarks:
        raise ValueError(
            f"reservoir ({reservoir}) must be >= n_landmarks "
            f"({n_landmarks})")
    sample = reservoir_sample(source, reservoir, seed=seed, loader=loader)
    sample_t = torch.from_numpy(sample).to(resolve_device(device))
    idx = partition_mod.select_landmarks(spec, sample_t, n_landmarks,
                                         jitter=jitter)
    return sample_t[idx]


def assign_strata_values(spec: kf.KernelSpec, x, z: Tensor) -> Tensor:
    """Eqn. 7 stratum for each row of ``x`` against landmark *values*
    ``z (S, d)`` — the RKHS-distance argmin of
    :func:`repro_torch.core.partition.assign_strata`, which takes indices.
    Runs on ``z``'s device (a host ``x`` is copied there)."""
    x = x.to(z.device) if torch.is_tensor(x) else \
        torch.tensor(np.asarray(x), device=z.device)
    kxz = kf.gram(spec, x, z)
    kzz = kf.gram_diag(spec, z)
    d2 = kzz[None, :] - 2.0 * kxz
    return torch.argmin(d2, dim=1).to(torch.int32)


class StreamingAssigner:
    """Stateful per-stratum round-robin partition assignment.

    Row ``r`` in stratum ``s`` gets partition ``c_s mod K`` where
    ``c_s`` counts rows of stratum ``s`` seen so far in stream order.
    Integer arithmetic only — the assignment for a given row depends on
    its global position within its stratum, so re-sharding the same
    stream leaves every label bitwise unchanged. The deterministic
    streaming analogue of :func:`repro_torch.core.partition
    .stratified_partitions` (which breaks ties randomly).
    """

    def __init__(self, spec: kf.KernelSpec, landmarks, n_partitions: int):
        if n_partitions < 1:
            raise ValueError(
                f"n_partitions must be >= 1, got {n_partitions}")
        self.spec = spec
        self.landmarks = torch.as_tensor(landmarks)
        self.n_partitions = int(n_partitions)
        self._counts = np.zeros(int(self.landmarks.shape[0]),
                                dtype=np.int64)

    def assign(self, x) -> tuple[np.ndarray, np.ndarray]:
        """Strata + partition labels for the next batch of rows, in
        stream order. Returns ``(stratum (n,), part (n,))`` int32 host
        arrays (one device read a batch)."""
        stratum = assign_strata_values(self.spec, x,
                                       self.landmarks).cpu().numpy()
        part = np.empty(stratum.shape[0], dtype=np.int32)
        # vectorized running count: offset of each row within the rows
        # of its stratum *inside this batch*, plus the carried count
        for s in np.unique(stratum):
            where = np.flatnonzero(stratum == s)
            part[where] = (self._counts[s] + np.arange(where.size)) \
                % self.n_partitions
            self._counts[s] += where.size
        return stratum, part


class StreamingPlan(NamedTuple):
    """Output of :func:`streaming_plan`: landmark values + a primed
    assigner. Counterpart of the dense ``partition.PartitionPlan``
    (which stores a full perm — a stream assigns lazily instead)."""
    landmarks: Tensor
    assigner: StreamingAssigner
    n_partitions: int


def streaming_plan(spec: kf.KernelSpec, source, n_partitions: int,
                   n_landmarks: int, *, reservoir: int = 4096,
                   seed: int = 0, loader=None,
                   device: str | torch.device | None = None
                   ) -> StreamingPlan:
    """One-scan plan: sketch Eqn. 8 landmarks on ``device`` (``None``:
    the card, as :func:`sketch_landmarks`), return an
    assigner that labels rows shard-locally as the solver streams them."""
    z = sketch_landmarks(spec, source, n_landmarks, reservoir=reservoir,
                         seed=seed, loader=loader, device=device)
    return StreamingPlan(z, StreamingAssigner(spec, z, n_partitions),
                         int(n_partitions))
