"""State carried from repro into repro_torch scores the same (1e-5).

A small problem is fitted with the JAX package on the CPU; its compiled
artifacts — exact, pruned and Nyström-compressed — are handed over as
numpy arrays and must score the same inputs equally. The port's own
compile step, fed the reference's dual, must build the same artifact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ODMEstimator as JEstimator
from repro.api import ProblemSpec as JProblem
from repro.core import kernel_fns as jkf
from repro.core.sodm import SODMConfig as JConfig
from repro.serve import model as jmodel
from repro_torch import interop
from repro_torch.core import kernel_fns as tkf
from repro_torch.serve import model as tmodel


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(0)
    x = rng.random((96, 5)).astype(np.float32)
    y = np.sign((x - 0.5) @ rng.standard_normal(5)).astype(np.float32)
    xt = rng.random((33, 5)).astype(np.float32)
    _, rep = JEstimator(JProblem.create("rbf", gamma=1.5, lam=10.0),
                        cfg=JConfig(levels=1, engine="pallas", block=16)).fit(
        x, y, jax.random.PRNGKey(0))
    return x, y, xt, rep.raw


def _carry(m, device="cpu"):
    arr = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return interop.fitted_from_numpy(
        dataclasses.asdict(m.spec), x_sv=arr(m.x_sv), coef=arr(m.coef),
        w=arr(m.w), n_train=m.n_train, compression=m.compression, gap=m.gap,
        device=device)


@pytest.mark.parametrize("kw", [dict(), dict(prune_tol=1e-3),
                                dict(budget=12)],
                         ids=["exact", "pruned", "nystrom"])
def test_carried_model_scores_the_same(fitted, kw):
    x, y, xt, res = fitted
    spec = jkf.KernelSpec("rbf", 1.5)
    jm = jmodel.from_sodm(spec, res, jnp.asarray(x), jnp.asarray(y), **kw)
    tm = _carry(jm)
    assert tm.compression == jm.compression and tm.n_sv == jm.n_sv
    want = np.asarray(jm.decision_function(jnp.asarray(xt)))
    for tiled in (None, False):
        got = tm.decision_function(xt, tiled=tiled).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(prune_tol=1e-3),
                                dict(budget=12, target=1e-2)],
                         ids=["exact", "pruned", "nystrom"])
def test_port_compiles_the_same_artifact(fitted, kw):
    x, y, xt, res = fitted
    jm = jmodel.from_sodm(jkf.KernelSpec("rbf", 1.5), res, jnp.asarray(x),
                          jnp.asarray(y), **kw)
    tres = interop.sodm_result_from_numpy(
        np.asarray(res.alpha), np.asarray(res.perm), res.sweeps_per_level,
        np.asarray(res.kkt), device="cpu")
    tm = tmodel.from_sodm(tkf.KernelSpec("rbf", 1.5), tres, torch.tensor(x),
                          torch.tensor(y), **kw)
    assert tm.compression == jm.compression and tm.n_sv == jm.n_sv
    assert tm.gap == pytest.approx(jm.gap, rel=1e-3, abs=1e-6)
    np.testing.assert_allclose(tm.decision_function(xt).numpy(),
                               np.asarray(jm.decision_function(
                                   jnp.asarray(xt))), rtol=1e-5, atol=1e-5)


def test_linear_collapse_and_argument_checks():
    rng = np.random.default_rng(1)
    x = rng.random((20, 4)).astype(np.float32)
    y = np.sign(rng.standard_normal(20)).astype(np.float32)
    a = np.abs(rng.standard_normal(40)).astype(np.float32)
    jm = jmodel.compile_model(jkf.KernelSpec("linear"), jnp.asarray(x),
                              jnp.asarray(y), jnp.asarray(a))
    tm = tmodel.compile_model(tkf.KernelSpec("linear"), torch.tensor(x),
                              torch.tensor(y), torch.tensor(a))
    assert tm.compression == "linear" and tm.n_sv == 0
    np.testing.assert_allclose(tm.w.numpy(), np.asarray(jm.w), rtol=1e-5,
                               atol=1e-5)
    carried = _carry(jm)
    np.testing.assert_allclose(carried.decision_function(x).numpy(),
                               np.asarray(jm.decision_function(
                                   jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        interop.fitted_from_numpy({"name": "rbf"}, w=np.ones(3),
                                  x_sv=np.ones((2, 3)), coef=np.ones(2),
                                  device="cpu")
