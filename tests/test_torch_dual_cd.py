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
    before = tcd.solve.launches.count
    got = tcd.solve(torch.tensor(Q), ODMParams(lam=lam), alpha0=None
                    if a0 is None else torch.tensor(a0), **kw)
    assert tcd.solve.launches.count == before          # CPU: no kernel launch
    assert int(got.sweeps) == int(want.sweeps)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u),
                               rtol=1e-5, atol=1e-5)
    # The KKT residual is max|g| with g = ±u + c·alpha + (theta ∓ 1): a
    # sum of O(1) terms that cancels to ~1e-5 at convergence, so its band
    # comes from fp32's unit roundoff times the terms, not the result.
    # Each side forms g with 3 roundings (<= 3·u32·T, T the largest sum
    # of |terms|), and its u carries the start's matvec Q (zeta - beta),
    # whose summation order is the BLAS's own (<= m·u32·A, A the largest
    # Σ_j |Q_ij||zeta_j - beta_j|; 0 for the zero start). On an AVX-512
    # CPU the two sides' KKT differ by 1.8e-7 where this band is 2.6e-6.
    p, u32 = ODMParams(lam=lam), 2.0 ** -24
    au, aa = np.abs(np.asarray(want.u)), np.asarray(want.alpha)
    cz, cb = m * p.c * p.ups, m * p.c
    T = max(float(np.max(au + cz * aa[:m] + abs(p.theta - 1.0))),
            float(np.max(au + cb * aa[m:] + abs(p.theta + 1.0))))
    A = 0.0 if a0 is None else float(np.max(np.abs(Q) @ np.abs(
        a0[:m] - a0[m:])))
    np.testing.assert_allclose(float(got.kkt), float(want.kkt), rtol=1e-4,
                               atol=2 * u32 * (3 * T + m * A))


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


def test_solve_zero_start_equals_explicit_zeros():
    # alpha0=None skips the start's matvec: u is zero, as Q @ 0 is
    m = 16
    Q = torch.tensor(np.stack([_q(6, m), _q(7, m)]))
    params = ODMParams(lam=20.0)
    cold = tcd.solve(Q, params, mscale=float(m), tol=1e-5, max_sweeps=40)
    zeros = tcd.solve(Q, params, mscale=float(m), tol=1e-5, max_sweeps=40,
                      alpha0=torch.zeros(2, 2 * m))
    for a, b in zip(cold, zeros):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("m", [1, 3, 4, 5, 24, 1103])
def test_transpose_padded_aligns_rows_of_the_transpose(m):
    """K4's copy of Q: row r is the reference's column Q[:, r], in rows
    of a stride padded to a multiple of 4 floats with zeros, so that every
    row is 16-byte aligned for the kernel's ring."""
    Q = torch.tensor(_q(2, m)).reshape(1, m, m).expand(2, m, m).clone()
    Q[1] *= 2.0
    qt = tcd.transpose_padded(Q)
    ld = qt.shape[-1]
    assert qt.shape == (2, m, ld) and ld % 4 == 0 and m <= ld < m + 4
    assert qt.is_contiguous()
    assert torch.equal(qt[..., :m], Q.transpose(-1, -2))
    assert torch.equal(qt[..., m:], torch.zeros(2, m, ld - m))


def test_solve_plain_counts_moving_steps():
    """``moves`` counts the steps whose delta is nonzero, per partition,
    and leaves the result as it was. A sweep visits each coordinate once,
    so its moving steps are the coordinates whose alpha changed."""
    m = 24
    Q = torch.tensor(np.stack([_q(3, m), _q(4, m)]))
    p = ODMParams(lam=10.0)
    kw = dict(mscale=float(m), tol=1e-5, max_sweeps=5)
    moves = torch.zeros(2, dtype=torch.int64)
    got = tcd.solve_plain(Q, p, moves=moves, **kw)
    want = tcd.solve_plain(Q, p, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got.sweeps.tolist() == [5, 5]
    alpha, u = torch.zeros(2, 2 * m), torch.zeros(2, m)
    qd = torch.diagonal(Q, dim1=-2, dim2=-1)
    changed = torch.zeros(2, dtype=torch.int64)
    for _ in range(5):
        before = alpha.clone()
        tcd._sweep(Q, qd, alpha, u, torch.ones(2, dtype=torch.bool), p,
                   float(m))
        changed += (alpha != before).sum(-1)
    assert torch.equal(moves, changed)
    assert (moves > 0).all() and (moves < 5 * 2 * m).all()


@pytest.mark.parametrize("kind", ["any", "moderate", "subnormal"])
def test_double_product_quotient_is_ieee(kind):
    """K4 divides g / h as float(double(g) * RN64(1 / h)) with no branch
    (csrc/cd_exact.cu): that must be IEEE's correctly rounded fp32
    quotient, the plain version's, bit for bit, special values included."""
    rng = np.random.default_rng({"any": 0, "moderate": 1, "subnormal": 2}[
        kind])
    n = 400_000
    if kind == "any":  # every finite bit pattern, either sign
        g, h = (rng.integers(0, 0x7F800000, n, dtype=np.int64)
                .astype(np.uint32).view(np.float32) for _ in range(2))
        g = np.where(rng.random(n) < 0.5, -g, g)
    elif kind == "moderate":
        g = (rng.standard_normal(n) * 10 ** rng.uniform(-8, 3, n))
        h = rng.random(n) * 10 ** rng.uniform(-2, 4, n)
    else:  # quotients near and below the normal range
        g = rng.standard_normal(n) * 10 ** rng.uniform(-45, -30, n)
        h = 2.0 ** rng.integers(-10, 10, n)
    g, h = g.astype(np.float32), h.astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 3.4e38,
                        1.0], np.float32)
    g = np.concatenate([g, np.repeat(special, special.size)])
    h = np.concatenate([h, np.tile(special, special.size)])
    with np.errstate(all="ignore"):
        want = g / h
        got = (g.astype(np.float64) * (1.0 / h.astype(np.float64))).astype(
            np.float32)
    nan = np.isnan(want) & np.isnan(got)
    assert np.array_equal(got.view(np.uint32)[~nan],
                          want.view(np.uint32)[~nan])
    assert np.array_equal(np.isnan(got), np.isnan(want))
