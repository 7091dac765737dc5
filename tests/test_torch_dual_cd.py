"""repro_torch.core.dual_cd.solve (K4's plain version on CPU tensors)
against repro.core.dual_cd.solve.

The plain version repeats the reference's coordinate update in its order,
so it takes the same sweeps and reaches alpha within 1e-5 (the reference
jits the loop, and XLA may contract a multiply-add the port rounds
twice). A batch of partitions is the reference's vmap: each partition
reports its own sweep count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dual_cd as jcd
from repro.core import kernel_fns as jkf
from repro.core.odm import ODMParams as JParams
from repro_torch.core import dual_cd as tcd
from repro_torch.core.odm import ODMParams


def _q(seed, m, d=4, gamma=0.8):
    rng = np.random.default_rng(seed)
    x = rng.random((m, d)).astype(np.float32)
    y = np.sign(rng.standard_normal(m)).astype(np.float32)
    return np.asarray(jkf.signed_gram(jkf.KernelSpec("rbf", gamma),
                                      jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("lam,tol,cap", [(10.0, 1e-5, 200),
                                         (100.0, 1e-4, 7),
                                         (1.0, 1e-6, 300)])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solve_plain_matches_reference(lam, tol, cap, warm):
    m = 24
    Q = _q(0, m)
    kw = dict(mscale=float(m), tol=tol, max_sweeps=cap)
    rng = np.random.default_rng(1)
    a0 = (np.abs(rng.standard_normal(2 * m)) * 0.05).astype(np.float32) \
        if warm else None
    want = jcd.solve(jnp.asarray(Q), JParams(lam=lam), alpha0=None
                     if a0 is None else jnp.asarray(a0), **kw)
    before = tcd.solve.launches
    got = tcd.solve(torch.tensor(Q), ODMParams(lam=lam), alpha0=None
                    if a0 is None else torch.tensor(a0), **kw)
    assert tcd.solve.launches == before          # CPU: no kernel launch
    assert int(got.sweeps) == int(want.sweeps)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.kkt), float(want.kkt), rtol=1e-4,
                               atol=1e-7)


def test_solve_batched_is_per_partition_reference():
    m = 16
    Qs = np.stack([_q(s, m, gamma=g) for s, g in ((2, 0.3), (3, 2.0),
                                                  (4, 0.9))])
    params = ODMParams(lam=20.0)
    got = tcd.solve(torch.tensor(Qs), params, mscale=float(m), tol=1e-5,
                    max_sweeps=150)
    for k in range(3):
        want = jcd.solve(jnp.asarray(Qs[k]), JParams(lam=20.0),
                         mscale=float(m), tol=1e-5, max_sweeps=150)
        assert int(got.sweeps[k]) == int(want.sweeps)
        np.testing.assert_allclose(got.alpha[k].numpy(),
                                   np.asarray(want.alpha), rtol=1e-5,
                                   atol=1e-5)


def test_solve_warm_start_within_tol_runs_zero_sweeps():
    m = 12
    Q = torch.tensor(_q(5, m))
    params = ODMParams(lam=5.0)
    res = tcd.solve(Q, params, mscale=float(m), tol=1e-6, max_sweeps=500)
    again = tcd.solve(Q, params, mscale=float(m), tol=1e-3,
                      alpha0=res.alpha, u0=res.u)
    assert int(again.sweeps) == 0
    assert torch.equal(again.alpha, res.alpha)
    assert float(tcd.kkt_from_u(res.u, res.alpha, params, float(m))) <= \
        float(np.float32(1e-6))
