"""SODM distribution-aware partition strategy (paper Section 3.2).

Port of ``repro.core.partition``:

1. **Landmark selection** (Eqn. 8) — greedy determinant-maximizing picks,
   i.e. pivoted Cholesky on the Gram's residual diagonal (z_1 = x_1).
2. **Stratum assignment** (Eqn. 7) — phi(i) = argmin_s
   ||phi(x_i) - phi(z_s)||² in the RKHS.
3. **Stratified partitioning** — a round-robin deal inside each stratum,
   so every partition keeps the global stratum proportions (±1).

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


def random_partitions(M: int, n_partitions: int,
                      key: torch.Generator | int | None,
                      device=None) -> Tensor:
    """Uniform random permutation — the strawman SODM improves on."""
    del n_partitions
    return torch.randperm(M, generator=as_generator(key)).to(device)
