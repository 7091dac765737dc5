"""repro_torch.kernels.score / ops.decision_scores against the reference.

``tiled=None`` and ``tiled=True`` reach score_tiles (its plain streaming
version on CPU tensors), ``tiled=False`` the dense oracle; all are held to
the reference's dense oracle and its interpret-mode kernel at 1e-5 for
every kernel family.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf
from repro.kernels import ops as jops
from repro.kernels import score as jscore
from repro_torch.core import kernel_fns as tkf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import score as tscore

FAMILIES = [("rbf", 0.7, 3, 1.0), ("laplacian", 0.3, 3, 1.0),
            ("poly", 0.25, 3, 1.0), ("linear", 1.0, 3, 1.0)]


def _data(seed=0, T=19, S=13, D=7):
    rng = np.random.default_rng(seed)
    return (rng.random((T, D)).astype(np.float32),
            rng.random((S, D)).astype(np.float32),
            rng.standard_normal(S).astype(np.float32))


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
def test_score_paths_match_reference(kind, gamma, degree, coef0):
    x, z, c = _data()
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    want = jscore.score_ref(jnp.asarray(x), jnp.asarray(z), jnp.asarray(c),
                            **kw)
    tx, tz, tc = torch.tensor(x), torch.tensor(z), torch.tensor(c)
    _close(tscore.score_ref(tx, tz, tc, **kw), want)
    _close(tscore.score_blocked(tx, tz, tc, bt=8, **kw), want)
    before = tscore.score_tiles.launches.count
    _close(tscore.score_tiles(tx, tz, tc, bt=8, **kw), want)
    assert tscore.score_tiles.launches.count == before   # CPU: plain version
    js = jkf.KernelSpec(kind, gamma, degree, coef0)
    ts = tkf.KernelSpec(kind, gamma, degree, coef0)
    for tiled in (None, True, False):
        _close(tops.decision_scores(tx, tz, tc, ts, bt=8, tiled=tiled),
               jops.decision_scores(jnp.asarray(x), jnp.asarray(z),
                                    jnp.asarray(c), js, bt=8, bs=8, bd=8,
                                    tiled=tiled))


@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES[:2])
def test_score_tiles_matches_interpret_kernel(kind, gamma, degree, coef0):
    x, z, c = _data(1, T=16, S=16, D=8)
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    want = jscore.score_tiles(jnp.asarray(x), jnp.asarray(z), jnp.asarray(c),
                              bt=8, bs=8, bd=8, interpret=True, **kw)
    got = tscore.score_tiles(torch.tensor(x), torch.tensor(z),
                             torch.tensor(c), bt=8, **kw)
    _close(got, want)
