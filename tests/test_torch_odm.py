"""repro_torch.core.odm (dual half) and core.dual_cd against the reference.

Module-level parity at 1e-5. The scalar and block CD solvers take the
same Q, warm start and tol and must agree on alpha and on the sweep count.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dual_cd as jcd, kernel_fns as jkf, odm as jodm
from repro_torch.core import dual_cd as tcd, kernel_fns as tkf
from repro_torch.core import odm as todm

PARAMS = [(1.0, 0.1, 0.5), (100.0, 0.2, 0.8)]


def _problem(seed=0, m=20, d=5, name="rbf"):
    rng = np.random.default_rng(seed)
    x = rng.random((m, d)).astype(np.float32)
    y = np.sign(rng.standard_normal(m)).astype(np.float32)
    q = np.asarray(jkf.signed_gram(jkf.KernelSpec(name, 0.5),
                                   jnp.asarray(x), jnp.asarray(y)))
    alpha = (np.abs(rng.standard_normal(2 * m)) * 0.1).astype(np.float32)
    alpha[rng.random(2 * m) < 0.3] = 0.0
    return x, y, q, alpha


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol,
                               atol=tol)


def test_params_match_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(todm.ODMParams)] \
        == [(f.name, f.default) for f in dataclasses.fields(jodm.ODMParams)]
    assert todm.ODMParams(2.0, 0.3, 0.7).c == jodm.ODMParams(2.0, 0.3, 0.7).c


@pytest.mark.parametrize("lam,theta,ups", PARAMS)
def test_dual_quantities(lam, theta, ups):
    _, _, q, alpha = _problem()
    jp, tp = jodm.ODMParams(lam, theta, ups), todm.ODMParams(lam, theta, ups)
    Q, a = torch.tensor(q), torch.tensor(alpha)
    jQ, ja = jnp.asarray(q), jnp.asarray(alpha)
    ms = 20.0
    _close(todm.dual_objective(Q, a, tp, ms), jodm.dual_objective(jQ, ja,
                                                                  jp, ms))
    _close(todm.dual_grad(Q, a, tp, ms), jodm.dual_grad(jQ, ja, jp, ms))
    _close(todm.kkt_residual(Q, a, tp, ms), jodm.kkt_residual(jQ, ja, jp,
                                                              ms))
    z, b = todm.split_alpha(a)
    u = Q @ (z - b)
    jz, jb = jodm.split_alpha(ja)
    ju = jQ @ (jz - jb)
    _close(todm.warm_start_scale(u, a, tp, ms),
           jodm.warm_start_scale(ju, ja, jp, ms))
    _close(todm.hess_diag(torch.diagonal(Q), tp, ms),
           jodm.hess_diag(jnp.diagonal(jQ), jp, ms))
    _close(tcd.kkt_from_u(u, a, tp, ms), jcd.kkt_from_u(ju, ja, jp, ms))
    # batched warm-start scale == per-row scale
    ub, ab = torch.stack([u, 2 * u]), torch.stack([a, 2 * a])
    got = todm.warm_start_scale(ub, ab, tp, ms)
    for k in range(2):
        _close(got[k], todm.warm_start_scale(ub[k], ab[k], tp, ms))


def test_cold_start_scale_is_one():
    tp = todm.ODMParams()
    assert float(todm.warm_start_scale(torch.zeros(4), torch.zeros(8), tp,
                                       4.0)) == 1.0


def test_decision_function_and_accuracy():
    x, y, _, alpha = _problem(1, m=16)
    xt = np.random.default_rng(5).random((7, x.shape[1])).astype(np.float32)
    spec_j, spec_t = jkf.KernelSpec("rbf", 0.5), tkf.KernelSpec("rbf", 0.5)
    got = todm.decision_function(spec_t, torch.tensor(x), torch.tensor(y),
                                 torch.tensor(alpha), torch.tensor(xt))
    want = jodm.decision_function(spec_j, jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(alpha), jnp.asarray(xt))
    _close(got, want)
    served = todm.predict(spec_t, torch.tensor(x), torch.tensor(y),
                          torch.tensor(alpha), torch.tensor(xt))
    torch.testing.assert_close(served, torch.sign(got))
    assert float(todm.accuracy(torch.tensor([1., -1., 1.]),
                               torch.tensor([1., 1., 1.]))) == \
        pytest.approx(2 / 3)


@pytest.mark.parametrize("name", ["rbf", "linear"])
def test_exact_cd_solve(name):
    _, _, q, alpha = _problem(2, m=12, name=name)
    jp, tp = jodm.ODMParams(10.0), todm.ODMParams(10.0)
    jr = jcd.solve(jnp.asarray(q), jp, 12.0, alpha0=jnp.asarray(alpha),
                   tol=1e-5, max_sweeps=300)
    tr = tcd.solve(torch.tensor(q), tp, 12.0, alpha0=torch.tensor(alpha),
                   tol=1e-5, max_sweeps=300)
    assert int(tr.sweeps) == int(jr.sweeps)
    _close(tr.alpha, jr.alpha)
    _close(tr.u, jr.u)
    _close(tr.kkt, jr.kkt)
    _close(tcd.objective(torch.tensor(q), tr.alpha, tp, 12.0),
           jcd.objective(jnp.asarray(q), jr.alpha, jp, 12.0))


def test_block_cd_solve_with_padding():
    _, _, q, alpha = _problem(3, m=20)
    jp, tp = jodm.ODMParams(10.0), todm.ODMParams(10.0)
    jr = jcd.solve_block(jnp.asarray(q), jp, 20.0, block=8,
                         alpha0=jnp.asarray(alpha), tol=1e-5, max_outer=300)
    tr = tcd.solve_block(torch.tensor(q), tp, 20.0, block=8,
                         alpha0=torch.tensor(alpha), tol=1e-5, max_outer=300)
    assert int(tr.sweeps) == int(jr.sweeps)
    _close(tr.alpha, jr.alpha)
    _close(tr.kkt, jr.kkt)


def test_batched_solve_keeps_per_partition_sweeps():
    """A converged partition stops while the others go on (vmap of a
    while_loop): batched counts equal the one-at-a-time counts."""
    qs, alphas = [], []
    for s in range(3):
        _, _, q, a = _problem(10 + s, m=10)
        qs.append(q)
        alphas.append(a * (s + 1))
    tp = todm.ODMParams(10.0)
    got = tcd.solve(torch.tensor(np.stack(qs)), tp, 10.0,
                    alpha0=torch.tensor(np.stack(alphas)), tol=1e-5)
    for k in range(3):
        one = tcd.solve(torch.tensor(qs[k]), tp, 10.0,
                        alpha0=torch.tensor(alphas[k]), tol=1e-5)
        assert int(got.sweeps[k]) == int(one.sweeps)
        torch.testing.assert_close(got.alpha[k], one.alpha)
