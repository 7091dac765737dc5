"""repro_torch.core.dsvrg (Algorithm 2) against repro.core.dsvrg.

The whole single-process solve runs through both packages on the same
data with the ``identity`` partition strategy (the packages' random
streams differ, so the stratified permutation is tested by its
invariant instead). ``w``, the per-epoch objective history and ``eta``
agree within 1e-5 relative — serial and parallel schedules, fused and
unfused directions, a batch that divides the partitions and one that
leaves a ragged tail. On these inputs no hinge coefficient flips
between the packages, so the tight band holds; the band documented for
DSVRG across reduction orders (relative 1e-2, prediction agreement 0.99)
is for orders far apart, as between the card and the CPU
(tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ODMEstimator as JEstimator
from repro.api import ProblemSpec as JProblem
from repro.core import dsvrg as jd, odm as jodm, sodm as jsodm
from repro_torch.api import ODMEstimator, ProblemSpec
from repro_torch.core import dsvrg as td, odm as todm, sodm as tsodm
from repro_torch.core import kernel_fns as tkf, partition as tpart
from repro_torch.kernels import odm_grad as tog
from repro_torch.serve import model as tmodel


def _data(seed=0, M=512, d=8, T=0):
    rng = np.random.default_rng(seed)
    x = rng.random((M + T, d)).astype(np.float32)
    y = np.sign((x - 0.5) @ rng.standard_normal(d)
                + 0.1 * rng.standard_normal(M + T)).astype(np.float32)
    return x[:M], y[:M], x[M:], y[M:]


def _rel(t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def test_config_matches_reference():
    fields = lambda c: [(f.name, f.default)  # noqa: E731
                        for f in dataclasses.fields(c)]
    assert fields(td.DSVRGConfig) == fields(jd.DSVRGConfig)
    assert tsodm.DSVRGConfig is td.DSVRGConfig


@pytest.mark.parametrize("m,batch", [(37, 8), (40, 8), (5, 16)])
def test_pad_batches_matches_reference(m, batch):
    rng = np.random.default_rng(1)
    xs = rng.random((3, m, 4)).astype(np.float32)
    ys = np.sign(rng.standard_normal((3, m))).astype(np.float32)
    got = td._pad_batches(torch.tensor(xs), torch.tensor(ys), batch)
    want = jd._pad_batches(jnp.asarray(xs), jnp.asarray(ys), batch)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_auto_eta_matches_reference():
    x, _, _, _ = _data(2, M=64)
    for p in [(1.0, 0.1, 0.5), (100.0, 0.3, 0.8)]:
        got = td.auto_eta(torch.tensor(x), todm.ODMParams(*p))
        want = jd.auto_eta(jnp.asarray(x), jodm.ODMParams(*p))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("batch", [16, 24], ids=["even", "ragged"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_solve_matches_reference(schedule, fused, batch):
    """M = 512, d = 8, K = 4 partitions of 128, 3 epochs. batch 24 leaves
    a tail of 8 rows in every partition. ``fused=True`` on the reference
    is its Pallas kernels in interpret mode; on the port it is the plain
    versions of B6 and B7 (``fused=None`` resolves to the same)."""
    x, y, _, _ = _data()
    kw = dict(n_partitions=4, epochs=3, batch=batch, schedule=schedule,
              partition_strategy="identity")
    params = (100.0, 0.1, 0.5)
    jr = jd._solve(jnp.asarray(x), jnp.asarray(y), jodm.ODMParams(*params),
                   jd.DSVRGConfig(fused=fused, **kw), jax.random.PRNGKey(0))
    tr = td._solve(torch.tensor(x), torch.tensor(y), todm.ODMParams(*params),
                   td.DSVRGConfig(fused=fused, **kw), 0)
    assert _rel(tr.w, jr.w) <= 1e-5
    assert tr.history.shape == (3,)
    assert _rel(tr.history, jr.history) <= 1e-5
    assert float(tr.eta) == pytest.approx(float(jr.eta), rel=1e-5)
    np.testing.assert_array_equal(tr.perm.numpy(), np.arange(512))


@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_every_sample_consumed_once_per_epoch(monkeypatch, schedule):
    """Column 0 carries each row's id; the recorder (in place of the fused
    step that the epoch's plain version takes on the CPU) sees every real
    row exactly once per epoch with weight 1, and padding only with
    weight 0. m = 30 with batch 8 leaves a tail of 6 in each of K = 3
    partitions."""
    M, K, epochs = 90, 3, 2
    x = torch.zeros(M, 3)
    x[:, 0] = torch.arange(1, M + 1, dtype=torch.float32)
    y = torch.ones(M)
    seen = []

    def record(w, anchor, h, xb, yb, wb, inv_n, **kw):
        ids = xb[..., 0].reshape(-1, xb.shape[-2])
        for row in ids:
            seen.append([(int(i), float(v), float(inv_n))
                         for i, v in zip(row, wb)])
        return torch.zeros_like(w)

    monkeypatch.setattr(tog, "odm_svrg_grad_plain", record)
    cfg = td.DSVRGConfig(n_partitions=K, epochs=epochs, batch=8,
                         schedule=schedule, partition_strategy="identity")
    td._solve(x, y, todm.ODMParams(), cfg, 0)
    assert len(seen) == epochs * K * 4           # S = ceil(30 / 8) = 4
    real = [i for st in seen for i, v, _ in st if v == 1.0]
    assert sorted(real) == sorted(list(range(1, M + 1)) * epochs)
    assert all(i == 0 for st in seen for i, v, _ in st if v == 0.0)
    tails = [st for st in seen if sum(v for _, v, _ in st) == 6]
    assert len(tails) == epochs * K
    assert all(inv == pytest.approx(1 / 6) for st in tails for *_, inv in st)


@pytest.mark.parametrize("schedule", ["serial", "parallel"])
@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
def test_fused_epochs_are_one_epoch_call_each(monkeypatch, schedule, fused):
    """The fused solve (the default) takes each epoch's inner steps in one
    odm_svrg_epoch call, with the schedule it runs (one launch of the
    epoch kernel an epoch on the card); the unfused one never calls it."""
    calls = []
    real = tog.odm_svrg_epoch

    def spy(*args, **kw):
        calls.append(kw["schedule"])
        return real(*args, **kw)

    monkeypatch.setattr(tog, "odm_svrg_epoch", spy)
    x, y, _, _ = _data(4, M=96, d=5)
    cfg = td.DSVRGConfig(n_partitions=4, epochs=3, batch=8, fused=fused,
                         schedule=schedule, partition_strategy="identity")
    res = td._solve(torch.tensor(x), torch.tensor(y), todm.ODMParams(), cfg,
                    0)
    assert calls == ([schedule] * 3 if fused is None else [])
    assert bool(torch.isfinite(res.history).all())


def test_stratified_plan_keeps_stratum_proportions():
    """The stratified plan on the linear kernel: every partition holds
    each input-space stratum's share, within the bound the deal-then-
    rebalance construction guarantees (test_torch_partition.py)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.random((240, 5)), dtype=torch.float32)
    K, S = 4, 6
    cfg = td.DSVRGConfig(n_partitions=K, n_landmarks=S)
    perm = td._partition_perm(x, cfg, K, 0).numpy()
    assert sorted(perm.tolist()) == list(range(240))
    spec = tkf.KernelSpec("linear")
    stratum = tpart.assign_strata(
        spec, x, tpart.select_landmarks(spec, x, S)).numpy()
    m = 240 // K
    n = np.bincount(stratum, minlength=S)
    counts = np.stack([np.bincount(stratum[perm[k * m:(k + 1) * m]],
                                   minlength=S) for k in range(K)])
    dealt = np.array([sum(ns // K + (k < ns % K) for ns in n)
                      for k in range(K)])
    carry = np.cumsum(dealt)[:-1] - m * np.arange(1, K)
    bound = 1 + max(carry.max(initial=0), 0)
    assert np.abs(counts - n / K).max() < bound


def test_solve_errors_and_unported_seams():
    x, y, _, _ = _data(4, M=60)
    X, Y, p = torch.tensor(x), torch.tensor(y), todm.ODMParams()
    with pytest.raises(ValueError, match="must divide"):
        td._solve(X, Y, p, td.DSVRGConfig(n_partitions=7), 0)
    with pytest.raises(ValueError, match="schedule"):
        td._solve(X, Y, p, td.DSVRGConfig(n_partitions=4, schedule="x"), 0)
    # the faults/resume seams are ported: a plan's dsvrg.segment site
    # fires once a segment (tests/test_torch_resume.py holds the rest)
    from repro_torch.distributed.faults import FaultPlan
    plan = FaultPlan()
    td._solve(X, Y, p, td.DSVRGConfig(n_partitions=4, epochs=2), 0,
              faults=plan)
    assert plan.fired == []
    plan = FaultPlan().kill_at_epoch(1)
    with pytest.raises(RuntimeError, match="dsvrg.segment"):
        td._solve(X, Y, p, td.DSVRGConfig(n_partitions=4, epochs=2), 0,
                  faults=plan)
    assert plan.fired == [("kill", "dsvrg.segment", {"epoch": 1})]


def test_tracker_segments_repeat_the_untracked_solve():
    """One tracker row per epoch; splitting the epochs into segments does
    not change the result (SVRG re-anchors at every epoch)."""
    x, y, _, _ = _data(5, M=96)
    cfg = td.DSVRGConfig(n_partitions=4, epochs=3, batch=8,
                         partition_strategy="identity")
    rows = []

    class Rec:
        def log_metrics(self, step, metrics):
            rows.append((step, metrics))

    X, Y, p = torch.tensor(x), torch.tensor(y), todm.ODMParams(10.0)
    plain = td._solve(X, Y, p, cfg, 0)
    traced = td._solve(X, Y, p, cfg, 0, tracker=Rec())
    torch.testing.assert_close(traced.w, plain.w, rtol=0, atol=0)
    torch.testing.assert_close(traced.history, plain.history, rtol=0,
                               atol=0)
    assert [s for s, _ in rows] == [1, 2, 3]
    assert [r["objective"] for _, r in rows] == plain.history.tolist()
    assert all(r["route"] == "dsvrg" and r["eta"] == float(plain.eta)
               for _, r in rows)


# ---------------------------------------------------------------------------
# through the front door
# ---------------------------------------------------------------------------

def _cfg(sodm_mod, dsvrg_mod, **kw):
    """SODMConfig whose dsvrg block keeps the identity order (an outer
    stratified or random strategy would carry over into it)."""
    dcfg = dsvrg_mod.DSVRGConfig(epochs=4, batch=8,
                                 partition_strategy="identity")
    return sodm_mod.SODMConfig(dsvrg=dcfg, partition_strategy="identity",
                               **kw)


def test_route_dsvrg_matches_reference_estimator():
    x, y, xt, _ = _data(6, M=160, T=40)
    jm, jr = JEstimator(JProblem.create("linear", lam=10.0), route="dsvrg",
                        cfg=_cfg(jsodm, jd)).fit(x, y, jax.random.PRNGKey(0))
    est = ODMEstimator(ProblemSpec.create("linear", lam=10.0), route="dsvrg",
                       cfg=_cfg(tsodm, td), device="cpu")
    tm, tr = est.fit(x, y, 0)
    assert tr.route == jr.route == "dsvrg" and tr.engine == "dsvrg"
    assert tr.passes == jr.passes == (4,)
    assert tm.compression == "linear" and tm.n_sv == 0
    assert tm.spec.name == "linear" and tm.n_train == 160
    assert _rel(tm.w, jm.w) <= 1e-5
    assert tr.eta == pytest.approx(jr.eta, rel=1e-5)
    assert len(tr.history) == 4
    assert _rel(tr.history, jr.history) <= 1e-5
    assert tr.kkt == pytest.approx(jr.kkt, rel=1e-3, abs=1e-6)
    fj = np.asarray(jm.decision_function(jnp.asarray(xt)))
    np.testing.assert_allclose(est.decision_function(xt).numpy(), fj,
                               rtol=1e-5, atol=1e-5)
    assert "eta=" in tr.summary() and "obj=" in tr.summary()


def test_auto_dispatch_at_the_threshold():
    """route=None with an unset engine: a linear problem at or above
    ``dsvrg_threshold`` goes to dsvrg, below it and for rbf to sodm."""
    x, y, _, _ = _data(7, M=96)
    for kernel, thr, want in (("linear", 96, "dsvrg"),
                              ("linear", 97, "sodm"),
                              ("rbf", 8, "sodm")):
        est = ODMEstimator(ProblemSpec.create(kernel),
                           cfg=_cfg(tsodm, td, levels=1,
                                   dsvrg_threshold=thr),
                           device="cpu")
        _, rep = est.fit(x, y, 0)
        assert rep.route == want
        assert (rep.eta is not None) == (want == "dsvrg")
    res = tsodm._solve(tkf.KernelSpec("linear"), torch.tensor(x),
                       torch.tensor(y), todm.ODMParams(),
                       _cfg(tsodm, td, dsvrg_threshold=10), 0)
    assert res.levels_run == 1 and res.sweeps_per_level == [4]


def test_nonlinear_kernel_on_route_dsvrg_raises():
    x, y, _, _ = _data(8, M=64)
    for kw in (dict(route="dsvrg"),
               dict(cfg=tsodm.SODMConfig(engine="dsvrg"))):
        est = ODMEstimator(ProblemSpec.create("rbf", gamma=0.5),
                           device="cpu", **kw)
        with pytest.raises(ValueError, match="capabilities"):
            est.fit(x, y)


def test_from_dsvrg_scores_x_at_w():
    x, y, xt, _ = _data(9, M=64, T=16)
    res = td._solve(torch.tensor(x), torch.tensor(y), todm.ODMParams(),
                    td.DSVRGConfig(n_partitions=4, epochs=2, batch=4), 0)
    m = tmodel.from_dsvrg(res)
    assert m.compression == "linear" and m.n_train == 64
    assert m.spec == tkf.KernelSpec("linear")
    torch.testing.assert_close(m.decision_function(xt),
                               torch.tensor(xt) @ res.w)
    torch.testing.assert_close(m.predict(xt), torch.sign(
        torch.tensor(xt) @ res.w))
