"""repro_torch.core.baselines and the five rival routes against
repro.core.baselines on the CPU.

The random draws of the two packages differ, so the reference's are
injected: the cascade's leaf permutation (``perm=``), dip's and dc's
layout (the port's ``perm=`` seam, identity inside), the per-epoch
permutations of svrg and csvrg (``_perms=``) and cluster_partitions'
initial centroids (``_init=``). The port's own samplers are held to
their invariants. Tolerances: the dual baselines within 1e-5 on alpha
with the same survivors and sweeps (both packages solve exactly from the
same Gram up to rounding); svrg and csvrg within the DSVRG band
(||dw|| / ||w|| <= 1e-2, prediction agreement >= 0.99), because the
fused direction sums in another order than two minibatch gradients and
a hinge kink can turn on the last bit.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ODMEstimator as JEstimator
from repro.api import ProblemSpec as JProblem
from repro.api import registry as jreg
from repro.core import baselines as jb
from repro.core import kernel_fns as jkf
from repro.core import partition as jpart
from repro.core import sodm as jsodm
from repro.core.dsvrg import DSVRGConfig as JDCfg
from repro.core.odm import ODMParams as JParams
from repro_torch import interop
from repro_torch.api import ODMEstimator, ProblemSpec
from repro_torch.api import registry as treg
from repro_torch.core import baselines as tb
from repro_torch.core import partition as tpart
from repro_torch.core import sodm as tsodm
from repro_torch.core.dsvrg import DSVRGConfig
from repro_torch.core.kernel_fns import KernelSpec
from repro_torch.core.odm import ODMParams
from repro_torch.serve import model as tmodel

JSPEC = jkf.KernelSpec("rbf", 0.7)
TSPEC = KernelSpec("rbf", 0.7)


def _data(seed=0, M=64, T=32, d=6):
    rng = np.random.default_rng(seed)
    x = (rng.random((M + T, d)) - 0.5).astype(np.float32)
    w = rng.standard_normal(d)
    y = np.sign(x @ w + 0.2 * rng.standard_normal(M + T))
    return x[:M], y[:M].astype(np.float32), x[M:], y[M:].astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels,lam,M", [(2, 10.0, 64), (3, 100.0, 96)])
def test_cascade_matches_reference(levels, lam, M):
    x, y, xt, _ = _data(1, M=M)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(3), M))
    want = jb._cascade_solve(JSPEC, jnp.asarray(x), jnp.asarray(y),
                             JParams(lam=lam), levels, jax.random.PRNGKey(0),
                             tol=1e-5, max_sweeps=100,
                             perm=jnp.asarray(perm))
    got = tb._cascade_solve(TSPEC, _t(x), _t(y), ODMParams(lam=lam), levels,
                            tol=1e-5, max_sweeps=100, perm=_t(perm))
    assert got.levels_run == want.levels_run == levels + 1
    # the same survivors, in the same order
    np.testing.assert_array_equal(got.x_sv.numpy(), np.asarray(want.x_sv))
    np.testing.assert_array_equal(got.y_sv.numpy(), np.asarray(want.y_sv))
    _close(got.alpha, want.alpha)
    # served from the survivors, as the reference serves them
    from repro.serve import model as jmodel
    _close(tmodel.from_cascade(TSPEC, got).decision_function(_t(xt)),
           jmodel.from_cascade(JSPEC, want).decision_function(
               jnp.asarray(xt)), 1e-4)


def test_top_support_breaks_ties_like_top_k():
    """Many instances sit at exactly 0 activity: the survivors among them
    are the lowest indices, as jax.lax.top_k keeps them."""
    rng = np.random.default_rng(2)
    m, keep = 12, 7
    x = rng.random((2, m, 3)).astype(np.float32)
    y = np.sign(rng.standard_normal((2, m))).astype(np.float32)
    a = np.zeros((2, 2 * m), np.float32)
    a[0, [3, 8]] = [0.5, 0.25]               # two zeta
    a[0, m + 5] = 0.5                        # a beta tying zeta_3
    a[1, m + 11] = 1.0
    got = tb._top_support(_t(x), _t(y), _t(a), keep)
    for k in range(2):
        want = jb._top_support(jnp.asarray(x[k]), jnp.asarray(y[k]),
                               jnp.asarray(a[k]), keep)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w))


def test_cascade_draws_a_permutation_and_checks_levels():
    x, y, _, _ = _data(4, M=32)
    res = tb._cascade_solve(TSPEC, _t(x), _t(y), ODMParams(lam=10.0), 2,
                            key=5, max_sweeps=50)
    assert res.x_sv.shape == (8, 6) and res.alpha.shape == (16,)
    # every survivor is a training row
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in res.x_sv.tolist())
    with pytest.raises(ValueError, match="must divide"):
        tb._cascade_solve(TSPEC, _t(x[:30]), _t(y[:30]),
                          ODMParams(lam=10.0), 2)


# ---------------------------------------------------------------------------
# cluster partitions, DiP and DC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [2, 4, 8])
def test_cluster_partitions_lloyd_matches_reference(K):
    """From the reference's initial centroids the port's Lloyd steps give
    assignments under which the reference's order is sorted by cluster,
    with the same cluster sizes."""
    x, _, _, _ = _data(5, M=96)
    key = jax.random.PRNGKey(K)
    want = np.asarray(jpart.cluster_partitions(JSPEC, jnp.asarray(x), K,
                                               key))
    init = np.asarray(jax.random.choice(key, 96, (K,), replace=False))
    a = tpart.lloyd_assign(_t(x), _t(init)).numpy()
    assert np.all(np.diff(a[want]) >= 0)
    got = tpart.cluster_partitions(TSPEC, _t(x), K, 0, _init=_t(init))
    np.testing.assert_array_equal(np.sort(got.numpy()), np.arange(96))
    assert np.all(np.diff(a[got.numpy()]) >= 0)
    np.testing.assert_array_equal(a[got.numpy()], a[want])


def test_cluster_partitions_invariants_and_sodm_strategy():
    x, _, _, _ = _data(6, M=64)
    perm = tpart.cluster_partitions(TSPEC, _t(x), 4, 11)
    np.testing.assert_array_equal(np.sort(perm.numpy()), np.arange(64))
    again = tpart.cluster_partitions(TSPEC, _t(x), 4, 11)
    assert torch.equal(perm, again)                 # seeded: repeatable
    cfg = tsodm.SODMConfig(levels=2, partition_strategy="cluster")
    assert torch.equal(tsodm._partition(TSPEC, _t(x), cfg, 4, 11), perm)


def _layout(x, y, seed, K0):
    """A fixed partition layout both packages solve from."""
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                             x.shape[0]))


@pytest.mark.parametrize("route", ["dip", "dc"])
@pytest.mark.parametrize("engine", [None, "pallas"])
def test_dip_dc_match_reference_on_the_reference_layout(route, engine):
    """The reference's own layout (its _dip_solve / _dc_solve output perm)
    injected into the port: the same alpha within 1e-5 and the same
    sweeps per level."""
    x, y, _, _ = _data(7, M=64)
    jcfg = jsodm.SODMConfig(levels=2, tol=1e-5, max_sweeps=150,
                            engine=engine, block=16)
    tcfg = tsodm.SODMConfig(levels=2, tol=1e-5, max_sweeps=150,
                            engine=engine, block=16)
    jfn = jb._dip_solve if route == "dip" else jb._dc_solve
    tfn = tb._dip_solve if route == "dip" else tb._dc_solve
    want = jfn(JSPEC, jnp.asarray(x), jnp.asarray(y), JParams(lam=10.0),
               jcfg, jax.random.PRNGKey(1))
    perm = _t(np.asarray(want.perm))
    got = tfn(TSPEC, _t(x), _t(y), ODMParams(lam=10.0), tcfg, perm=perm)
    assert torch.equal(got.perm, perm)
    sweeps = np.array([int(s) for s in want.sweeps_per_level])
    if engine is None:
        assert got.sweeps_per_level == sweeps.tolist()
        _close(got.alpha, want.alpha)
    else:
        # the greedy engine's band (tests/test_torch_sodm.py): its argmax
        # turns last-bit differences into other coordinate orders, so a
        # level may end one pass apart
        assert np.abs(np.array(got.sweeps_per_level) - sweeps).max() <= 1
        _close(got.alpha, want.alpha, 1e-4)


def test_dip_draws_a_stratified_cluster_layout():
    x, y, _, _ = _data(8, M=64)
    cfg = tsodm.SODMConfig(levels=2, n_landmarks=4, max_sweeps=50)
    res = tb._dip_solve(TSPEC, _t(x), _t(y), ODMParams(lam=10.0), cfg, 3)
    np.testing.assert_array_equal(np.sort(res.perm.numpy()), np.arange(64))
    # DiP deals every cluster slab across the partitions: with 4 slabs of
    # 16 and 4 partitions of 16, each partition holds 4 +- 1 of each slab
    perm_c = tpart.cluster_partitions(TSPEC, _t(x), 4,
                                      tpart.as_generator(3))
    slab = torch.empty(64, dtype=torch.int64)
    slab[perm_c] = torch.arange(64) // 16
    counts = np.stack([np.bincount(slab[res.perm[k * 16:(k + 1) * 16]]
                                   .numpy(), minlength=4)
                       for k in range(4)])
    assert counts.sum() == 64 and counts.shape == (4, 4)
    res_dc = tb._dc_solve(TSPEC, _t(x), _t(y), ODMParams(lam=10.0), cfg, 3)
    assert torch.equal(res_dc.perm, tpart.cluster_partitions(
        TSPEC, _t(x), 4, 3))


# ---------------------------------------------------------------------------
# svrg, csvrg and the coreset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,n", [(64, 9), (100, 25)])
def test_kcenter_coreset_picks_the_reference_indices(M, n):
    rng = np.random.default_rng(M)
    x = rng.random((M, 5)).astype(np.float32)
    want = np.asarray(jb.kcenter_coreset(jnp.asarray(x), n))
    got = tb.kcenter_coreset(_t(x), n)
    np.testing.assert_array_equal(got.numpy(), want)


def _ref_perms(key, M, epochs):
    return [np.asarray(jax.random.permutation(jax.random.fold_in(key, e), M))
            for e in range(epochs)]


@pytest.mark.parametrize("route,batch", [("svrg", 1), ("svrg", 4),
                                         ("csvrg", 1), ("csvrg", 8)])
def test_grad_baselines_match_reference(route, batch):
    x, y, xt, _ = _data(9, M=96, d=8)
    params, eta, epochs = (10.0, 0.05, 4)
    key = jax.random.PRNGKey(2)
    perms = [torch.tensor(p) for p in _ref_perms(key, 96, epochs)]
    if route == "svrg":
        want = jb._svrg_solve(jnp.asarray(x), jnp.asarray(y),
                              JParams(lam=params), epochs, eta, key, batch)
        got = tb._svrg_solve(_t(x), _t(y), ODMParams(lam=params), epochs,
                             eta, batch=batch, _perms=perms)
    else:
        want = jb._csvrg_solve(jnp.asarray(x), jnp.asarray(y),
                               JParams(lam=params), epochs, eta, key, 0.25,
                               batch)
        got = tb._csvrg_solve(_t(x), _t(y), ODMParams(lam=params), epochs,
                              eta, coreset_frac=0.25, batch=batch,
                              _perms=perms)
    w_ref = np.asarray(want.w)
    rel = np.linalg.norm(got.w.numpy() - w_ref) / np.linalg.norm(w_ref)
    assert rel <= 1e-2
    agree = np.mean(np.sign(xt @ got.w.numpy()) == np.sign(xt @ w_ref))
    assert agree >= 0.99
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history),
                               rtol=1e-2)
    conv = interop.grad_result_from_numpy(want.w, want.history,
                                          device="cpu")
    assert conv.w.dtype == torch.float32 and conv.history.shape == (epochs,)


def test_grad_baselines_draw_their_own_permutations():
    x, y, _, _ = _data(10, M=64, d=5)
    a = tb._svrg_solve(_t(x), _t(y), ODMParams(lam=10.0), 3, 0.05, key=4)
    b = tb._svrg_solve(_t(x), _t(y), ODMParams(lam=10.0), 3, 0.05, key=4)
    assert torch.equal(a.w, b.w) and a.history.shape == (3,)
    assert float(a.history[-1]) < float(a.history[0])


@pytest.mark.parametrize("route", ["svrg", "csvrg"])
def test_grad_baselines_take_one_epoch_call_an_epoch(monkeypatch, route):
    """svrg and csvrg run each epoch's M // batch steps as one chain in one
    odm_svrg_epoch call (one launch of the epoch kernel on the card), with
    one all-ones mask and 1/batch shared by every step."""
    from repro_torch.kernels import odm_grad as tog
    seen = []
    real = tog.odm_svrg_epoch

    def spy(w, anchor, h, xs, ys, wts, inv_n, eta, **kw):
        seen.append((tuple(xs.shape), wts.stride(0), inv_n.stride(0),
                     float(wts.min()), float(inv_n[0]), kw["schedule"]))
        return real(w, anchor, h, xs, ys, wts, inv_n, eta, **kw)

    monkeypatch.setattr(tog, "odm_svrg_epoch", spy)
    x, y, _, _ = _data(11, M=48, d=5)
    solve = tb._svrg_solve if route == "svrg" else tb._csvrg_solve
    solve(_t(x), _t(y), ODMParams(lam=10.0), 2, 0.05, key=1, batch=4)
    assert seen == [((1, 12, 4, 5), 0, 0, 1.0, 0.25, "serial")] * 2


# ---------------------------------------------------------------------------
# the routes, end to end
# ---------------------------------------------------------------------------

def test_registry_holds_the_reference_routes_and_capabilities():
    """All seven routes, each with the reference's capabilities (sodm and
    dsvrg mesh-aware since A13)."""
    assert treg.routes() == jreg.routes()
    for name in jreg.routes():
        assert treg.get(name).capabilities() == jreg.get(name).capabilities()


@pytest.mark.parametrize("route", ["cascade", "dip", "dc", "svrg", "csvrg"])
def test_route_fits_scores_saves_and_loads(route, tmp_path):
    x, y, xt, yt = _data(11, M=64)
    kernel = "linear" if route in ("svrg", "csvrg") else "rbf"
    cfg = tsodm.SODMConfig(levels=2, max_sweeps=60,
                           dsvrg=DSVRGConfig(epochs=3, batch=4))
    est = ODMEstimator(ProblemSpec.create(kernel, gamma=0.7, lam=10.0),
                       route=route, cfg=cfg, device="cpu")
    model, rep = est.fit(x, y, 0)
    assert rep.route == route
    f = est.decision_function(xt)
    assert f.shape == (32,) and bool(torch.isfinite(f).all())
    assert est.score(xt, yt) > 0.6
    est.save(str(tmp_path))
    back = ODMEstimator.load(str(tmp_path), device="cpu")
    assert torch.equal(back.decision_function(xt), f)
    # the reference loads the port's artifact and scores alike
    jm = JEstimator.load(str(tmp_path))
    np.testing.assert_allclose(np.asarray(jm.decision_function(
        jnp.asarray(xt))), f.numpy(), rtol=1e-5, atol=1e-5)


def test_streaming_cascade_raises_naming_its_item():
    """The streaming cascade (y is None: x is a ShardedSource) trains as
    the registry's cascade route; it pairs the leaves of the dense
    cascade with the identity layout, and scores alike."""
    from repro_torch.data import streaming as tds
    x, y, xt, _ = _data(12, M=64)
    cfg = tsodm.SODMConfig(levels=2, max_sweeps=50)
    out = treg._fit_cascade(ProblemSpec(), tds.ArraySource(x, y, 20), None,
                            0, cfg=cfg, compile_kw={},
                            fit_kw={"device": "cpu"})
    assert out.passes == (3,) and out.raw.x_sv.shape[0] == 16
    dense = tb._cascade_solve(ProblemSpec().kernel, _t(x), _t(y),
                              ProblemSpec().params, levels=2,
                              max_sweeps=50, perm=torch.arange(64))
    _close(out.model.decision_function(_t(xt)),
           tmodel.from_cascade(ProblemSpec().kernel,
                               dense).decision_function(_t(xt)), 1e-5)


def test_cascade_result_interop_serves_like_the_reference():
    x, y, xt, _ = _data(12, M=32)
    want = jb._cascade_solve(JSPEC, jnp.asarray(x), jnp.asarray(y),
                             JParams(lam=10.0), 2, jax.random.PRNGKey(0),
                             max_sweeps=50)
    res = interop.cascade_result_from_numpy(want.x_sv, want.y_sv, want.alpha,
                                            want.levels_run, device="cpu")
    from repro.serve import model as jmodel
    _close(tmodel.from_cascade(TSPEC, res).decision_function(_t(xt)),
           jmodel.from_cascade(JSPEC, want).decision_function(
               jnp.asarray(xt)), 1e-5)
