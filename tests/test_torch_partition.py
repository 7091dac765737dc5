"""repro_torch.core.partition against repro.core.partition.

Landmarks and strata are deterministic given x: exact indices. The random
partitions draw from a torch.Generator, not the JAX stream, so the test
holds the invariant instead: every partition keeps each stratum's share,
within the bound the deal-then-rebalance construction guarantees (see
``_deviation_and_bound``), and the reference meets the same bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf, partition as jpart
from repro_torch.core import kernel_fns as tkf, partition as tpart


def _x(seed=0, m=96, d=6):
    return np.random.default_rng(seed).random((m, d)).astype(np.float32)


@pytest.mark.parametrize("name,gamma", [("rbf", 2.0), ("laplacian", 0.5),
                                        ("poly", 0.5)])
def test_landmarks_and_strata_match(name, gamma):
    x = _x()
    js, ts = jkf.KernelSpec(name, gamma), tkf.KernelSpec(name, gamma)
    jl = np.asarray(jpart.select_landmarks(js, jnp.asarray(x), 6))
    tl = tpart.select_landmarks(ts, torch.tensor(x), 6).numpy()
    np.testing.assert_array_equal(tl, jl)
    js_ = np.asarray(jpart.assign_strata(js, jnp.asarray(x),
                                         jnp.asarray(jl)))
    ts_ = tpart.assign_strata(ts, torch.tensor(x), torch.tensor(tl)).numpy()
    np.testing.assert_array_equal(ts_, js_)


def _deviation_and_bound(perm, stratum, K):
    """Worst |count of stratum s in partition k − n_s/K|, and the bound the
    algorithm guarantees. The round-robin deal alone is within ±1; the
    rebalance to equal slabs then moves the first partitions' overflow
    (C_j elements across boundary j) into their neighbours, so a slab can
    gain C_j and lose C_{j+1} of one stratum: |dev| < 1 + max_j C_j."""
    stratum = np.asarray(stratum)
    perm = np.asarray(perm)
    M = stratum.shape[0]
    m = M // K
    n = np.bincount(stratum)
    counts = np.stack([np.bincount(stratum[perm[k * m:(k + 1) * m]],
                                   minlength=n.shape[0]) for k in range(K)])
    dealt = np.array([sum(ns // K + (k < ns % K) for ns in n)
                      for k in range(K)])
    carry = np.cumsum(dealt)[:-1] - m * np.arange(1, K)
    return np.abs(counts - n / K).max(), 1 + max(carry.max(initial=0), 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K", [2, 4, 8])
def test_stratified_partitions_keep_proportions(seed, K):
    """Holds the port and the reference to the same invariant. Both leave
    ±1 once the rebalance moves overflow: the reference docstring's "±1"
    covers the deal only (ROADMAP queue C)."""
    rng = np.random.default_rng(seed)
    M = 8 * 24
    stratum = rng.integers(0, 5, M)
    perm = tpart.stratified_partitions(torch.tensor(stratum), K, seed)
    assert sorted(perm.tolist()) == list(range(M))
    dev, bound = _deviation_and_bound(perm, stratum, K)
    assert dev < bound
    jperm = jpart.stratified_partitions(jnp.asarray(stratum), K,
                                        jax.random.PRNGKey(seed))
    jdev, jbound = _deviation_and_bound(jperm, stratum, K)
    assert jbound == bound and jdev < jbound


def test_plan_composes_the_three_steps():
    x = _x(3, m=128)
    spec = tkf.KernelSpec("rbf", 2.0)
    plan = tpart.make_plan(spec, torch.tensor(x), 4, 4,
                           torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        plan.landmarks, tpart.select_landmarks(spec, torch.tensor(x), 4))
    torch.testing.assert_close(
        plan.stratum, tpart.assign_strata(spec, torch.tensor(x),
                                          plan.landmarks))
    dev, bound = _deviation_and_bound(plan.perm, plan.stratum, 4)
    assert dev < bound
    again = tpart.make_plan(spec, torch.tensor(x), 4, 4, 0)
    torch.testing.assert_close(again.perm, plan.perm)
    with pytest.raises(ValueError):
        tpart.make_plan(spec, torch.tensor(x[:30]), 2, 4, 0)


def test_random_partitions_is_a_seeded_permutation():
    a = tpart.random_partitions(50, 5, 7)
    b = tpart.random_partitions(50, 5, torch.Generator().manual_seed(7))
    assert sorted(a.tolist()) == list(range(50))
    torch.testing.assert_close(a, b)
