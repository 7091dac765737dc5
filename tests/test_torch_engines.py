"""repro_torch.core.engines against repro.core.engines.

Every level engine gets the same partitions and merged warm start as the
reference's: alphas and KKTs at 1e-5, equal sweep counts. The pallas
engine is run dense (m <= gram_threshold) and matrix-free (threshold
lowered below m) for all four kernel families. Its diagonal Gram tiles,
which the port builds with one ``ops.gram`` call (B8 on the card), are
held to the reference's ``vmap(kf.signed_gram)`` at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as jeng, kernel_fns as jkf, odm as jodm
from repro_torch.core import engines as teng, kernel_fns as tkf
from repro_torch.core import odm as todm
from repro_torch.kernels import gram as tgram

FAMILIES = [("rbf", 0.7, 3, 1.0), ("laplacian", 0.3, 3, 1.0),
            ("poly", 0.3, 2, 1.0), ("linear", 1.0, 3, 1.0)]


def _level(seed=0, K=2, m=20, d=4):
    rng = np.random.default_rng(seed)
    x = rng.random((K, m, d)).astype(np.float32)
    y = np.sign(rng.standard_normal((K, m))).astype(np.float32)
    a = (np.abs(rng.standard_normal((K, 2 * m))) * 0.05).astype(np.float32)
    a[rng.random((K, 2 * m)) < 0.4] = 0.0
    return x, y, a


def _run(engine, family, **extra):
    name, gamma, degree, coef0 = family
    x, y, a = _level()
    common = dict(tol=1e-5, max_sweeps=60, **extra)
    jfn = getattr(jeng, f"solve_level_{engine}")
    tfn = getattr(teng, f"solve_level_{engine}")
    ja, js, jk = jfn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(a),
                     spec=jkf.KernelSpec(name, gamma, degree, coef0),
                     params=jodm.ODMParams(lam=5.0), **common)
    ta, ts, tk = tfn(torch.tensor(x), torch.tensor(y), torch.tensor(a),
                     spec=tkf.KernelSpec(name, gamma, degree, coef0),
                     params=todm.ODMParams(lam=5.0), **common)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)
    return ts


@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: f[0])
@pytest.mark.parametrize("threshold", [4096, 8], ids=["dense", "mfree"])
def test_pallas_engine_matches(family, threshold):
    _run("pallas", family, block=8, gram_threshold=threshold)


@pytest.mark.parametrize("family", FAMILIES[:2], ids=lambda f: f[0])
def test_scalar_engine_matches(family):
    _run("scalar", family)


@pytest.mark.parametrize("family", FAMILIES[:2], ids=lambda f: f[0])
def test_block_engine_matches(family):
    _run("block", family, block=8)


def test_make_local_solver_names():
    assert teng.make_local_solver(None) is teng.solve_level_scalar
    for name in ("block", "pallas"):
        assert callable(teng.make_local_solver(name))
    with pytest.raises(ValueError, match="whole-problem"):
        teng.make_local_solver("dsvrg")
    with pytest.raises(ValueError):
        teng.make_local_solver("nope")
    assert teng.LEVEL_ENGINES == jeng.LEVEL_ENGINES


def test_converged_warm_start_reports_zero_sweeps():
    """Algorithm 1 line 5 reads a 0-sweep level as converged."""
    x, y, _ = _level(1)
    kw = dict(spec=tkf.KernelSpec("rbf", 0.7), params=todm.ODMParams(5.0),
              tol=1e-5, max_sweeps=80, block=8)
    a, s, _ = teng.solve_level_pallas(torch.tensor(x), torch.tensor(y),
                                      torch.zeros(2, 40), **kw)
    a2, s2, k2 = teng.solve_level_pallas(torch.tensor(x), torch.tensor(y),
                                         a, **kw)
    assert int(s.max()) > 0 and int(s2.max()) == 0
    torch.testing.assert_close(a2, a)


@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: f[0])
def test_diag_blocks_match_reference_vmap(family):
    """engines.diag_blocks (one ops.gram over the (K·nblk, B, d) reshape)
    against the reference's vmap(kf.signed_gram) of the same blocks;
    padded rows and columns (label 0) come out exactly 0."""
    name, gamma, degree, coef0 = family
    K, m, d, B = 3, 37, 5, 16
    nblk = -(-m // B)
    mp = nblk * B
    rng = np.random.default_rng(7)
    xp = np.zeros((K, mp, d), np.float32)
    xp[:, :m] = rng.random((K, m, d))
    yp = np.zeros((K, mp), np.float32)
    yp[:, :m] = np.sign(rng.standard_normal((K, m)))
    spec = jkf.KernelSpec(name, gamma, degree, coef0)
    want = jax.vmap(lambda xb, yb: jkf.signed_gram(spec, xb, yb))(
        jnp.asarray(xp.reshape(K * nblk, B, d)),
        jnp.asarray(yp.reshape(K * nblk, B)))
    before = tgram.gram.launches.count
    got = teng.diag_blocks(tkf.KernelSpec(name, gamma, degree, coef0),
                           torch.tensor(xp), torch.tensor(yp), B)
    assert tgram.gram.launches.count == before  # CPU: the plain version
    assert tuple(got.shape) == (K, nblk, B, B)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).reshape(K, nblk, B, B), rtol=1e-5,
        atol=1e-5)
    pad = (yp == 0).reshape(K, nblk, B)
    g = got.numpy()
    assert np.all(g[pad] == 0.0)                                # rows
    assert np.all(np.swapaxes(g, -1, -2)[pad] == 0.0)           # columns


@pytest.mark.parametrize("threshold", [4096, 8], ids=["dense", "mfree"])
def test_pallas_engine_on_cpu_launches_no_b8(threshold):
    x, y, a = _level(2)
    before = tgram.gram.launches.count
    teng.solve_level_pallas(torch.tensor(x), torch.tensor(y),
                            torch.tensor(a), spec=tkf.KernelSpec("rbf", 0.7),
                            params=todm.ODMParams(5.0), tol=1e-5,
                            max_sweeps=20, block=8, gram_threshold=threshold)
    assert tgram.gram.launches.count == before
