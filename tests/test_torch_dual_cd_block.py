"""repro_torch.kernels.dual_cd_block against repro.kernels.dual_cd_block.

The reference's Pallas kernels run in interpret mode (as its own tests
run them on the CPU); the port's CPU tensors take the plain versions of
K1 (greedy sweep), K2 and K3. Alphas and u at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf
from repro.kernels import dual_cd_block as jcdk
from repro.kernels import gram as jgram
from repro.kernels import ops as jops
from repro_torch.core import kernel_fns as tkf
from repro_torch.kernels import dual_cd_block as tcdk
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import ops as tops

CD = dict(c=0.5, ups=0.5, theta=0.1)


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol,
                               atol=tol)


def _level(seed=0, K=2, nblk=2, B=8, d=5, name="rbf", pad=3):
    rng = np.random.default_rng(seed)
    mp = nblk * B
    x = rng.random((K, mp, d)).astype(np.float32)
    y = np.sign(rng.standard_normal((K, mp))).astype(np.float32)
    valid = (np.arange(mp) < mp - pad).astype(np.float32)
    y = y * valid
    spec = jkf.KernelSpec(name, 0.7)
    Q = np.stack([np.asarray(jkf.signed_gram(spec, jnp.asarray(x[k]),
                                             jnp.asarray(y[k])))
                  for k in range(K)])
    qb = np.stack([np.asarray(jcdk.extract_diag_blocks(jnp.asarray(Q[k]), B))
                   for k in range(K)])
    a = (np.abs(rng.standard_normal((K, nblk, 2 * B))) * 0.05).astype(
        np.float32)
    a *= np.concatenate([valid, valid]).reshape(1, 2, nblk, B).transpose(
        0, 2, 1, 3).reshape(1, nblk, 2 * B)
    u = (rng.standard_normal((K, nblk, B)) * 0.1).astype(np.float32)
    return x, y, valid, Q, qb, a, u


@pytest.mark.parametrize("exit_tol", [0.0, 5e-2])
@pytest.mark.parametrize("n_steps", [5, 16])
def test_cd_block_sweep_matches_interpret_kernel(exit_tol, n_steps):
    _, _, valid, _, qb, a, u = _level(pad=3)
    T, B = 4, 8
    qb, a, u = qb.reshape(T, B, B), a.reshape(T, 2 * B), u.reshape(T, B)
    v = np.tile(valid.reshape(2, B), (2, 1))
    kw = dict(CD, mscale=16.0, n_steps=n_steps, exit_tol=exit_tol)
    ja, ju = jcdk.cd_block_sweep(jnp.asarray(qb), jnp.asarray(a),
                                 jnp.asarray(u), valids=jnp.asarray(v),
                                 interpret=True, **kw)
    ta, tu = tcdk.cd_block_sweep(torch.tensor(qb), torch.tensor(a),
                                 torch.tensor(u), valids=torch.tensor(v),
                                 **kw)
    _close(ta, ja)
    _close(tu, ju)
    # padded coordinates never move
    pad = np.concatenate([v, v], axis=1) == 0
    np.testing.assert_array_equal(ta.numpy()[pad], a[pad])


def test_extract_diag_blocks():
    Q = np.arange(36, dtype=np.float32).reshape(6, 6)
    _close(tcdk.extract_diag_blocks(torch.tensor(Q), 3),
           jcdk.extract_diag_blocks(jnp.asarray(Q), 3))


@pytest.mark.parametrize("source", ["dense", "kernel"])
def test_fused_pass_matches_interpret_kernel(source):
    x, y, valid, Q, qb, a, u = _level(1, pad=3)
    K, nblk, B = 2, 2, 8
    v = np.broadcast_to(valid.reshape(1, nblk, B), (K, nblk, B)).copy()
    kw = dict(CD, mscale=16.0, n_steps=2 * B, exit_tol=1e-4)
    if source == "dense":
        jsrc = jgram.DenseSource(jnp.asarray(Q))
        tsrc = tgram.DenseSource(torch.tensor(Q))
    else:
        jsrc = jgram.make_kernel_source(jkf.KernelSpec("rbf", 0.7),
                                        jnp.asarray(x), jnp.asarray(y),
                                        bm=B, bn=B, bd=8, interpret=True)
        tsrc = tgram.make_kernel_source(tkf.KernelSpec("rbf", 0.7),
                                        torch.tensor(x), torch.tensor(y),
                                        bm=B)
    ja, jud = jcdk.fused_cd_pass(jnp.asarray(qb), jsrc, jnp.asarray(a),
                                 jnp.asarray(u), jnp.asarray(v),
                                 interpret=True, **kw)
    ta, tud = tcdk.fused_cd_pass(torch.tensor(qb), tsrc, torch.tensor(a),
                                 torch.tensor(u), torch.tensor(v), **kw)
    _close(ta, ja)
    _close(tud, jud)


@pytest.mark.parametrize("source", ["dense", "kernel"])
def test_solve_level_matches_reference(source):
    x, y, valid, Q, qb, _, _ = _level(2, pad=3)
    K, nblk, B = 2, 2, 8
    m = nblk * B
    rng = np.random.default_rng(7)
    a0 = (np.abs(rng.standard_normal((K, 2 * m))) * 0.02).astype(np.float32)
    a0 *= np.concatenate([valid, valid])[None]
    kw = dict(CD, mscale=float(m), n_passes=40, tol=1e-5)
    if source == "dense":
        jsrc, tsrc = jgram.DenseSource(jnp.asarray(Q)), \
            tgram.DenseSource(torch.tensor(Q))
    else:
        jsrc = jgram.make_kernel_source(jkf.KernelSpec("rbf", 0.7),
                                        jnp.asarray(x), jnp.asarray(y),
                                        bm=B, bn=B, bd=8, interpret=True)
        tsrc = tgram.make_kernel_source(tkf.KernelSpec("rbf", 0.7),
                                        torch.tensor(x), torch.tensor(y),
                                        bm=B)
    ja, jr, jit = jcdk.solve_level(jnp.asarray(qb), jsrc, jnp.asarray(a0),
                                   valid=jnp.asarray(valid), interpret=True,
                                   **kw)
    ta, tr, tit = tcdk.solve_level(torch.tensor(qb), tsrc,
                                   torch.tensor(a0),
                                   valid=torch.tensor(valid), **kw)
    assert tit == int(jit)
    _close(ta, ja)
    _close(tr, jr)


def test_ops_dual_cd_solve_pads_and_warm_starts():
    rng = np.random.default_rng(3)
    M = 21
    x = rng.random((M, 4)).astype(np.float32)
    y = np.sign(rng.standard_normal(M)).astype(np.float32)
    Q = np.asarray(jkf.signed_gram(jkf.KernelSpec("rbf", 0.5),
                                   jnp.asarray(x), jnp.asarray(y)))
    a0 = (np.abs(rng.standard_normal(2 * M)) * 0.01).astype(np.float32)
    kw = dict(CD, mscale=float(M), block=8, tol=1e-5)
    ja, jk, jp = jops.dual_cd_solve(jnp.asarray(Q), alpha0=jnp.asarray(a0),
                                    **kw)
    ta, tk, tp = tops.dual_cd_solve(torch.tensor(Q), alpha0=torch.tensor(a0),
                                    **kw)
    assert tp == int(jp)
    _close(ta, ja)
    _close(tk, jk)


def test_flush_subnormals():
    tiny = np.finfo(np.float32).tiny
    a = torch.tensor([0.0, 1e-45, tiny / 2, tiny, 0.5, -1e-40])
    np.testing.assert_array_equal(tcdk.flush_subnormals(a).numpy(),
                                  np.array([0.0, 0.0, 0.0, tiny, 0.5, 0.0],
                                           np.float32))


@pytest.mark.parametrize("m,B,offset,cap", [(60, 16, 0, 300),
                                            (56, 16, 200, 300),
                                            (60, 16, 0, 100)])
def test_solve_level_lam100_converges_like_reference(m, B, offset, cap):
    # phishing's setting (lam = 100, rbf at the median gamma, padded
    # tiles). The line search shrinks a coordinate the sweep clipped to 0
    # by (1 - t) a pass; the reference flushes it to 0 once it is
    # subnormal and converges. Kept as a subnormal, it stops at the least
    # one and holds |g| in the KKT: the level then runs more passes than
    # the reference's, or to the cap. With a cap short of convergence
    # (the last case) both stop at it with the same KKT above tol.
    from repro_torch.core.odm import ODMParams
    from repro_torch.data import synthetic
    ds = synthetic.load("phishing", scale=0.25)
    spec = tkf.KernelSpec("rbf", float(tkf.median_gamma(ds.x_train)))
    p = ODMParams(lam=100.0, theta=0.1, ups=0.5)
    nblk = -(-m // B)
    mp = nblk * B
    valid = (torch.arange(mp) < m).float()
    x = torch.nn.functional.pad(ds.x_train[offset:offset + m], (0, 0, 0,
                                                                mp - m))
    y = torch.nn.functional.pad(ds.y_train[offset:offset + m], (0, mp - m))
    Q = (tkf.signed_gram(spec, x, y) * valid[:, None] * valid[None, :])[None]
    qb = tcdk.extract_diag_blocks(Q, B).contiguous()
    kw = dict(c=p.c, ups=p.ups, theta=p.theta, mscale=float(m), tol=1e-4,
              n_passes=cap)
    ja, jr, jit = jcdk.solve_level(
        jnp.asarray(qb.numpy()), jgram.DenseSource(jnp.asarray(Q.numpy())),
        jnp.zeros((1, 2 * mp)), valid=jnp.asarray(valid.numpy()),
        interpret=True, **kw)
    ta, tr, tit = tcdk.solve_level(qb, tgram.DenseSource(Q.contiguous()),
                                   torch.zeros(1, 2 * mp), valid=valid, **kw)
    # The pass that converges is the one on which the last such coordinate
    # turns subnormal and is flushed. It halves about once a pass (2.8e-38
    # to 1.5e-38 across pass 114 in the first case), while the two sides'
    # values differ by a few fp32 roundings of the BLAS's sums, far less
    # than a factor of 2: that can move the flush by one pass, no more.
    # So a converged solve may take one pass more or less than the
    # reference's; a solve held back by a kept subnormal runs to the cap
    # with the KKT above tol (C-2), and one cut by the cap stops at it.
    converged = tit < cap
    assert abs(tit - int(jit)) <= 1 and (int(jit) < cap) == converged
    assert (float(tr[0]) <= kw["tol"]) == converged
    assert (float(jr[0]) <= kw["tol"]) == converged
    if not converged:
        _close(tr, jr)
    _close(ta, ja)


def test_transpose_tiles_transposes_each_tile_and_counts():
    # K1 reads column c of a tile as row c of this copy
    q = torch.tensor(np.random.default_rng(9).standard_normal((3, 5, 5)),
                     dtype=torch.float32)
    before = tcdk.transpose_tiles.copies
    qt = tcdk.transpose_tiles(q)
    assert tcdk.transpose_tiles.copies == before + 1
    assert qt.is_contiguous()
    for t in range(3):
        assert torch.equal(qt[t], q[t].T)
    # the view the level solve hands its passes: q's values over qt's
    # storage, which a pass's reshape keeps
    view = qt.transpose(-1, -2)
    assert torch.equal(view, q)
    assert view.reshape(3, 5, 5).transpose(-1, -2).is_contiguous()


def test_solve_level_on_cpu_makes_no_transposed_copy():
    # the CPU plain path reads q_blocks as given: the copy is for K1 only
    _, _, valid, Q, qb, _, _ = _level(3, pad=3)
    K, m = 2, 16
    before = tcdk.transpose_tiles.copies
    _, _, it = tcdk.solve_level(torch.tensor(qb),
                                tgram.DenseSource(torch.tensor(Q)),
                                torch.zeros(K, 2 * m),
                                valid=torch.tensor(valid), c=0.5, ups=0.5,
                                theta=0.1, mscale=float(m), n_passes=3,
                                tol=1e-9)
    assert it == 3
    assert tcdk.transpose_tiles.copies == before
