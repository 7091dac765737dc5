"""SODM distribution-aware partition strategy (paper Section 3.2).

Port of ``repro.core.partition``:

1. **Landmark selection** (Eqn. 8) — greedy determinant-maximizing picks,
   i.e. pivoted Cholesky on the Gram's residual diagonal (z_1 = x_1).
2. **Stratum assignment** (Eqn. 7) — phi(i) = argmin_s
   ||phi(x_i) - phi(z_s)||² in the RKHS.
3. **Stratified partitioning** — a round-robin deal inside each stratum,
   so every partition keeps the global stratum proportions (±1).

Rival strategies for the baselines: :func:`random_partitions` and
:func:`cluster_partitions` (k-means clusters as partitions); and the
diagnostics of the theory checks, :func:`offdiag_mass` (Theorem 1's
Q-bar) and :func:`min_principal_angle`.

The output is a permutation ``perm`` of [M]; partition k is
``perm[k*m:(k+1)*m]``. Random draws come from a ``torch.Generator``
(seeded CPU stream, moved to the data's device), so a given seed gives
the same partitions on the CPU and on the card. They are not the JAX
stream's numbers: tests compare invariants, and solver parity injects
the reference's ``perm`` through ``partition_strategy="identity"``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kernel_fns as kf
from repro_torch.kernels import ops

Tensor = torch.Tensor


class PartitionPlan(NamedTuple):
    perm: Tensor         # (M,) permutation: partition k = perm[k*m:(k+1)*m]
    landmarks: Tensor    # (S,) indices of the landmark points
    stratum: Tensor      # (M,) stratum index of each ORIGINAL instance
    n_partitions: int    # K


def as_generator(key: torch.Generator | int | None) -> torch.Generator:
    """The port's stand-in for a PRNG key: a CPU ``torch.Generator``
    (an int seeds one; None seeds 0)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(0 if key is None else int(key))


def _uniform(gen: torch.Generator, n: int, device) -> Tensor:
    return torch.rand(n, generator=gen, dtype=torch.float32).to(device)


# ---------------------------------------------------------------------------
# landmark selection (Eqn. 8)
# ---------------------------------------------------------------------------

def select_landmarks(spec: kf.KernelSpec, x: Tensor, n_landmarks: int,
                     jitter: float = 1e-6) -> Tensor:
    """Greedy determinant-maximizing landmark indices (Eqn. 8): the Schur
    complement r² - K_szᵀ K_ss⁻¹ K_sz is the residual diagonal of the
    pivoted Cholesky, so each round picks its argmax and updates it in
    O(M)."""
    M = x.shape[0]
    resid = kf.gram_diag(spec, x)
    L = torch.zeros(n_landmarks, M, dtype=x.dtype, device=x.device)
    picks = torch.zeros(n_landmarks, dtype=torch.int64, device=x.device)
    for s in range(n_landmarks):
        i = 0 if s == 0 else int(torch.argmax(resid))
        picks[s] = i
        kcol = kf.gram(spec, x, x[i:i + 1])[:, 0]
        proj = L.T @ L[:, i]
        denom = torch.sqrt(torch.clamp_min(resid[i], jitter))
        ell = (kcol - proj) / denom
        L[s] = ell
        resid = torch.clamp_min(resid - ell * ell, 0.0)
        resid[i] = 0.0
    return picks


# ---------------------------------------------------------------------------
# stratum assignment (Eqn. 7)
# ---------------------------------------------------------------------------

def assign_strata(spec: kf.KernelSpec, x: Tensor,
                  landmark_idx: Tensor) -> Tensor:
    """phi(i) = argmin_s k(z_s, z_s) - 2 k(x_i, z_s) (k(x, x) is constant
    in s)."""
    z = x[landmark_idx]
    kxz = kf.gram(spec, x, z)
    kzz = kf.gram_diag(spec, z)
    d2 = kzz[None, :] - 2.0 * kxz
    return torch.argmin(d2, dim=1)


# ---------------------------------------------------------------------------
# stratified partition construction
# ---------------------------------------------------------------------------

def _lexsort(primary: Tensor, tie: Tensor) -> Tensor:
    """Order by (primary, tie): ``jnp.lexsort((tie, primary))`` as two
    stable sorts."""
    order = torch.argsort(tie, stable=True)
    return order[torch.argsort(primary[order], stable=True)]


def stratified_partitions(stratum: Tensor, n_partitions: int,
                          key: torch.Generator | int | None) -> Tensor:
    """Permutation placing a proportional random slice of every stratum in
    each partition: rank instances inside their stratum in random order,
    deal rank r to partition r mod K, then order by (partition, random) —
    position r of the result goes to partition r // (M/K)."""
    gen = as_generator(key)
    M = stratum.shape[0]
    K = n_partitions
    tie = _uniform(gen, M, stratum.device)
    order = _lexsort(stratum, tie)
    sorted_stratum = stratum[order]
    is_start = torch.ones(M, dtype=torch.bool, device=stratum.device)
    is_start[1:] = sorted_stratum[1:] != sorted_stratum[:-1]
    pos = torch.arange(M, device=stratum.device)
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    part_of_sorted = (pos - seg_start) % K
    part = torch.empty_like(part_of_sorted)
    part[order] = part_of_sorted
    tie2 = _uniform(gen, M, stratum.device)
    return _lexsort(part, tie2)


def make_plan(spec: kf.KernelSpec, x: Tensor, n_landmarks: int,
              n_partitions: int,
              key: torch.Generator | int | None) -> PartitionPlan:
    """Full Section-3.2 pipeline: landmarks -> strata -> partitions."""
    M = x.shape[0]
    if M % n_partitions != 0:
        raise ValueError(f"K={n_partitions} must divide M={M} "
                         "(pad or trim the data set first)")
    landmarks = select_landmarks(spec, x, n_landmarks)
    stratum = assign_strata(spec, x, landmarks)
    perm = stratified_partitions(stratum, n_partitions, key)
    return PartitionPlan(perm=perm, landmarks=landmarks, stratum=stratum,
                         n_partitions=n_partitions)


# ---------------------------------------------------------------------------
# rival partition strategies (for ablation / baselines)
# ---------------------------------------------------------------------------

def random_partitions(M: int, n_partitions: int,
                      key: torch.Generator | int | None,
                      device=None) -> Tensor:
    """Uniform random permutation — the strawman SODM improves on."""
    del n_partitions
    return torch.randperm(M, generator=as_generator(key)).to(device)


def lloyd_assign(x: Tensor, init: Tensor, iters: int = 10) -> Tensor:
    """Cluster ids after ``iters`` Lloyd steps from the centroids
    ``x[init]``: the assignment of the last step, made with the centroids
    before its update (the reference's ``lax.scan`` output). Ties go to
    the lower cluster id (``argmin``)."""
    K = init.shape[0]
    cent = x[init]
    xx = torch.sum(x * x, 1)[:, None]
    a = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for _ in range(iters):
        d2 = xx + torch.sum(cent * cent, 1)[None, :] - 2.0 * x @ cent.T
        a = torch.argmin(d2, 1)
        onehot = torch.nn.functional.one_hot(a, K).to(x.dtype)
        counts = torch.clamp_min(onehot.sum(0), 1.0)
        cent = (onehot.T @ x) / counts[:, None]
    return a


def cluster_partitions(spec: kf.KernelSpec, x: Tensor, n_partitions: int,
                       key: torch.Generator | int | None, iters: int = 10,
                       *, _init: Tensor | None = None) -> Tensor:
    """Clusters-as-partitions (DC-SVM / DiP-SVM style): Lloyd's algorithm
    in input space from K distinct random rows (:func:`lloyd_assign`),
    then the rows ordered by (cluster, random tie) — partition k is the
    k-th contiguous slab of the result.

    The reference's docstring promises cluster sizes forced to M/K; its
    code only sorts (``partition.py:203-205``), and so does this port:
    clusters are cut into slabs wherever M/K falls. ``_init`` injects the
    K initial row indices (the parity tests hand over the reference's
    draw); ``spec`` is unused, as in the reference."""
    del spec
    gen = as_generator(key)
    M = x.shape[0]
    K = n_partitions
    init = torch.randperm(M, generator=gen)[:K] if _init is None else _init
    a = lloyd_assign(x, init.to(x.device), iters)
    tie = _uniform(gen, M, x.device)
    return _lexsort(a, tie)


# ---------------------------------------------------------------------------
# diagnostics used by theory tests and benchmarks
# ---------------------------------------------------------------------------

def _cross(pid: Tensor) -> Tensor:
    return pid[:, None] != pid[None, :]


def offdiag_mass(spec: kf.KernelSpec, x: Tensor, y: Tensor, perm: Tensor,
                 n_partitions: int) -> Tensor:
    """Q-bar of Theorem 1: the sum of |Q_ij| over cross-partition pairs,
    with Q through ``ops.gram`` (B8 on the card). O(M²) memory."""
    xp, yp = x[perm], y[perm]
    Q = ops.gram(xp, None, spec, yx=yp)
    M = x.shape[0]
    pid = torch.arange(M, device=x.device) // (M // n_partitions)
    return torch.sum(torch.where(_cross(pid), torch.abs(Q), 0.0))


def min_principal_angle(spec: kf.KernelSpec, x: Tensor, stratum: Tensor,
                        n_landmarks: int) -> Tensor:
    """cos(tau) estimate: the largest cross-stratum normalized kernel
    value, with K through ``ops.gram`` (B8 on the card)."""
    del n_landmarks
    K = ops.gram(x, None, spec)
    diag = torch.sqrt(torch.clamp_min(kf.gram_diag(spec, x), 1e-12))
    Kn = K / (diag[:, None] * diag[None, :])
    return torch.max(torch.where(_cross(stratum), Kn, -torch.inf))
