"""repro_torch.core.theory and the partition diagnostics against
repro.core.theory / repro.core.partition on the CPU.

Both packages solve the global and the block-diagonal duals exactly from
the same data (Grams through ops.gram here, signed_gram there); the
evaluated gaps and bounds agree within 1e-4 relative and ``holds`` is the
same. Q-bar and cos(tau) are sums and maxima of the same Gram, within
1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf
from repro.core import partition as jpart
from repro.core import theory as jth
from repro.core.odm import ODMParams as JParams
from repro_torch.core import kernel_fns as tkf
from repro_torch.core import partition as tpart
from repro_torch.core import theory as tth
from repro_torch.core.odm import ODMParams


def _data(seed, M=32, d=4):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal((M // 2, d)) + 0.8,
                        rng.standard_normal((M // 2, d)) - 0.8])
    y = np.concatenate([np.ones(M // 2), -np.ones(M // 2)])
    perm = rng.permutation(M)
    return x[perm].astype(np.float32), y[perm].astype(np.float32)


def _rel(t, j, tol=1e-4):
    np.testing.assert_allclose(float(t), float(j), rtol=tol, atol=1e-6)


@pytest.mark.parametrize("seed,theta,ups,K", [(0, 0.1, 0.5, 2),
                                              (1, 0.3, 0.8, 4),
                                              (2, 0.05, 0.3, 8)])
def test_theorem1_matches_reference(seed, theta, ups, K):
    x, y = _data(seed)
    spec = ("rbf", 0.7)
    want = jth.eval_theorem1(jkf.KernelSpec(*spec), jnp.asarray(x),
                             jnp.asarray(y), JParams(1.0, theta, ups), K,
                             tol=1e-7)
    got = tth.eval_theorem1(tkf.KernelSpec(*spec), torch.tensor(x),
                            torch.tensor(y), ODMParams(1.0, theta, ups), K,
                            tol=1e-7)
    assert bool(got.holds) == bool(want.holds)
    for name in ("gap_objective", "gap_solution", "bound_objective",
                 "bound_solution"):
        _rel(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("seed,theta", [(3, 0.1), (4, 0.35)])
def test_theorem2_matches_reference(seed, theta):
    x, y = _data(seed)
    K = 4
    plan = jpart.make_plan(jkf.KernelSpec("rbf", 0.7), jnp.asarray(x), K, K,
                           jax.random.PRNGKey(seed))
    kw = dict(n_partitions=K, tol=1e-7)
    want = jth.eval_theorem2(jkf.KernelSpec("rbf", 0.7), jnp.asarray(x),
                             jnp.asarray(y), JParams(1.0, theta, 0.5),
                             plan.stratum, perm=plan.perm, **kw)
    got = tth.eval_theorem2(tkf.KernelSpec("rbf", 0.7), torch.tensor(x),
                            torch.tensor(y), ODMParams(1.0, theta, 0.5),
                            torch.tensor(np.asarray(plan.stratum)),
                            perm=torch.tensor(np.asarray(plan.perm)), **kw)
    assert bool(got.holds) == bool(want.holds)
    for name in ("gap", "bound", "cos_tau"):
        _rel(getattr(got, name), getattr(want, name))
    with pytest.raises(ValueError, match="diag_value"):
        tth.eval_theorem2(tkf.KernelSpec("poly"), torch.tensor(x),
                          torch.tensor(y), ODMParams(), torch.zeros(32),
                          K, torch.arange(32))


@pytest.mark.parametrize("kind", ["rbf", "laplacian", "linear"])
def test_offdiag_mass_and_principal_angle_match_reference(kind):
    x, y = _data(5, M=40, d=3)
    perm = np.random.default_rng(6).permutation(40)
    stratum = np.arange(40) % 5
    js, ts = jkf.KernelSpec(kind, 0.5), tkf.KernelSpec(kind, 0.5)
    _rel(tpart.offdiag_mass(ts, torch.tensor(x), torch.tensor(y),
                            torch.tensor(perm), 4),
         jpart.offdiag_mass(js, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(perm), 4), 1e-5)
    _rel(tpart.min_principal_angle(ts, torch.tensor(x),
                                   torch.tensor(stratum), 5),
         jpart.min_principal_angle(js, jnp.asarray(x), jnp.asarray(stratum),
                                   5), 1e-5)
    _rel(tth.part_cos_tau(ts, torch.tensor(x), torch.tensor(stratum)),
         jth.part_cos_tau(js, jnp.asarray(x), jnp.asarray(stratum)), 1e-5)


def test_global_and_blockwise_solves_match_reference():
    x, y = _data(7)
    want = jth.solve_global_and_blockwise(
        jkf.KernelSpec("rbf", 0.7), jnp.asarray(x), jnp.asarray(y),
        JParams(lam=4.0), 4, tol=1e-6)
    got = tth.solve_global_and_blockwise(
        tkf.KernelSpec("rbf", 0.7), torch.tensor(x), torch.tensor(y),
        ODMParams(lam=4.0), 4, tol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # the block-diagonal Gram keeps exactly the partitions' own blocks
    assert float(got[1][:8, 8:].abs().max()) == 0.0
    assert torch.equal(got[1][8:16, 8:16], got[0][8:16, 8:16])
