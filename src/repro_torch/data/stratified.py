"""Stratified data-parallel sharding — the paper's partition strategy as
a data-pipeline feature. Port of ``repro.data.stratified``.

If each data-parallel rank's shard is distributionally skewed, per-rank
gradients are biased. ``assign_ranks`` runs the landmark / stratum
construction (``core.partition.make_plan``) on a feature sketch of the
corpus and deals every stratum round-robin across ranks, so each rank
sees the global mixture; ``distribution_skew`` measures how far a
rank's mean strays from the global one.
"""
from __future__ import annotations

import torch

from repro_torch.core import kernel_fns as kf
from repro_torch.core import partition as part

Tensor = torch.Tensor


def assign_ranks(features: Tensor, n_ranks: int, n_landmarks: int = 8,
                 seed: int = 0, kernel: str = "rbf",
                 gamma: float = 1.0) -> Tensor:
    """Returns perm such that rank r owns features[perm[r*m:(r+1)*m]].

    features: (N, d) sketch of the corpus items (one row per shard-able
    unit — documents, shards, or examples).
    """
    n = features.shape[0]
    if n % n_ranks != 0:
        raise ValueError(f"n_ranks={n_ranks} must divide N={n}")
    spec = kf.KernelSpec(name=kernel, gamma=gamma)
    return part.make_plan(spec, features, n_landmarks, n_ranks, seed).perm


def distribution_skew(features: Tensor, perm: Tensor, n_ranks: int) -> Tensor:
    """Max over ranks of || mean_rank - mean_global || — the first-order
    distribution preservation metric the paper optimizes. Lower is
    better."""
    n, d = features.shape
    xp = features[perm].reshape(n_ranks, n // n_ranks, d)
    means = torch.mean(xp, dim=1)
    g = torch.mean(features, dim=0)
    return torch.max(torch.linalg.norm(means - g[None, :], dim=1))
