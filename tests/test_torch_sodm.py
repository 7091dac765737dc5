"""A whole Algorithm-1 fit: repro_torch against repro on the CPU.

The reference's stratified permutation is injected through
``partition_strategy="identity"`` (the random streams differ). The fit
must take the same sweeps per level and give the same predictions;
alpha agrees within 1e-4 and decision values within 1e-3. The band is
looser than the modules' 1e-5 for a reason: the greedy argmax inside the
tile sweeps turns last-bit differences (XLA's and PyTorch's reduction
orders in the line search and the KKT) into different coordinate orders
over many passes, so the two trajectories end at nearby — not identical —
points inside the KKT tolerance.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ODMEstimator as JEstimator
from repro.api import ProblemSpec as JProblem
from repro.core import kernel_fns as jkf, partition as jpart
from repro.core import sodm as jsodm
from repro_torch.api import ODMEstimator, ProblemSpec
from repro_torch.core import sodm as tsodm


def _data(seed=0, M=160, T=40, d=6):
    rng = np.random.default_rng(seed)
    x = rng.random((M + T, d)).astype(np.float32)
    w = rng.standard_normal(d)
    y = np.sign((x - 0.5) @ w + 0.1 * rng.standard_normal(M + T))
    y = y.astype(np.float32)
    return x[:M], y[:M], x[M:], y[M:]


@pytest.mark.parametrize("threshold", [4096, 30], ids=["dense", "mfree"])
def test_full_fit_matches_reference(threshold):
    x, y, xt, yt = _data()
    gamma = float(jkf.median_gamma(jnp.asarray(x)))
    perm = np.asarray(jpart.make_plan(jkf.KernelSpec("rbf", gamma),
                                      jnp.asarray(x), 4, 8,
                                      jax.random.PRNGKey(0)).perm)
    x, y = x[perm], y[perm]
    cfg = dict(p=2, levels=3, tol=1e-4, max_sweeps=100, engine="pallas",
               block=16, gram_threshold=threshold,
               partition_strategy="identity")
    jm, jr = JEstimator(JProblem.create("rbf", gamma=gamma, lam=10.0),
                        cfg=jsodm.SODMConfig(**cfg)).fit(
        x, y, jax.random.PRNGKey(0))
    est = ODMEstimator(ProblemSpec.create("rbf", gamma=gamma, lam=10.0),
                       cfg=tsodm.SODMConfig(**cfg), device="cpu")
    tm, tr = est.fit(x, y, 0)
    assert list(tr.passes) == list(jr.passes)
    np.testing.assert_allclose(tr.raw.alpha.numpy(), np.asarray(jr.raw.alpha),
                               atol=1e-4)
    fj = np.asarray(jm.decision_function(jnp.asarray(xt)))
    ft = est.decision_function(xt).numpy()
    np.testing.assert_allclose(ft, fj, atol=1e-3)
    np.testing.assert_array_equal(np.sign(ft), np.sign(fj))
    assert est.score(xt, yt) == pytest.approx(
        float(np.mean(np.sign(fj) == yt)))


def test_merge_and_split_match_reference():
    a = np.arange(24, dtype=np.float32).reshape(3, 8)
    got = tsodm.merge_alphas(torch.tensor(a))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsodm.merge_alphas(
                                      jnp.asarray(a))))
    back = tsodm.split_to_partitions(got, 3)
    np.testing.assert_array_equal(back.numpy(), a)
    grouped = torch.tensor(a.reshape(1, 3, 8))
    np.testing.assert_array_equal(tsodm.merge_alphas(grouped)[0].numpy(),
                                  got.numpy())


def test_config_fields_match_reference():
    import dataclasses
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tsodm.SODMConfig)[:-2] == fields(jsodm.SODMConfig)[:-2]
    assert tsodm.SODMConfig().dsvrg_threshold == \
        jsodm.SODMConfig().dsvrg_threshold
    assert dataclasses.asdict(tsodm.SODMConfig().dsvrg) == \
        dataclasses.asdict(jsodm.SODMConfig().dsvrg)


def test_tracker_and_trace_spans(tmp_path):
    x, y, _, _ = _data(1, M=64)
    rows = []

    class Rec:
        def log_metrics(self, step, metrics):
            rows.append(metrics)

    est = ODMEstimator(ProblemSpec.create("rbf", gamma=1.0),
                       cfg=tsodm.SODMConfig(levels=2, engine="pallas",
                                            block=16), device="cpu")
    _, rep = est.fit(x, y, 0, tracker=Rec(), trace_dir=str(tmp_path))
    levels = [r for r in rows if "level" in r]
    assert [r["level"] for r in levels] == [2, 1, 0][:rep.raw.levels_run]
    assert rows[-1]["fit_done"] is True
    events = json.load(open(os.path.join(tmp_path, "trace.json")))
    events = events["traceEvents"]
    fit = [e for e in events if e["name"] == "fit"]
    lv = [e for e in events if e["name"] == "cascade.level"]
    assert len(fit) == 1 and len(lv) == rep.raw.levels_run
    for e in lv:
        assert fit[0]["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= fit[0]["ts"] + fit[0]["dur"]


def test_unported_seams_raise(tmp_path):
    x, y, _, _ = _data(2, M=32)
    X, Y = torch.tensor(x), torch.tensor(y)
    from repro_torch.core.kernel_fns import KernelSpec
    from repro_torch.core.odm import ODMParams
    # the faults seam is ported (A12): the cascade.level site fires
    # before each level solve, on the level loop and on the dsvrg route
    from repro_torch.distributed.faults import FaultPlan, Preemption
    with pytest.raises(Preemption, match="cascade.level"):
        tsodm._solve(KernelSpec(), X, Y, ODMParams(),
                     tsodm.SODMConfig(levels=1), 0,
                     faults=FaultPlan().kill_at_level(0))
    # the sharded solve runs (A13): on a one-rank gloo mesh every level is
    # replicated, so it equals the one-process solve bit for bit
    from repro_torch.launch.mesh import make_host_mesh
    from torch_dist_util import gloo_world
    with gloo_world(tmp_path / "store"):
        cfg = tsodm.SODMConfig(levels=2, max_sweeps=20)
        one = tsodm._solve(KernelSpec(), X, Y, ODMParams(), cfg, 0)
        shd = tsodm._solve_sharded(KernelSpec(), X, Y, ODMParams(), cfg, 0,
                                   make_host_mesh((1,), ("data",)))
        assert torch.equal(one.perm, shd.perm)
        assert torch.equal(one.alpha, shd.alpha)
        assert one.sweeps_per_level == shd.sweeps_per_level
    with pytest.raises(Preemption, match="dsvrg.segment"):
        tsodm._solve(KernelSpec("linear"), X, Y, ODMParams(),
                     tsodm.SODMConfig(engine="dsvrg"), 0,
                     faults=FaultPlan().kill_at_epoch(0))
    # the cluster strategy is ported; an unknown one raises
    res = tsodm._solve(KernelSpec(), X, Y, ODMParams(),
                       tsodm.SODMConfig(levels=1, max_sweeps=5,
                                        partition_strategy="cluster"), 0)
    assert sorted(res.perm.tolist()) == list(range(32))
    with pytest.raises(ValueError):
        tsodm._solve(KernelSpec(), X, Y, ODMParams(),
                     tsodm.SODMConfig(partition_strategy="nope"), 0)
    with pytest.raises(ValueError, match="must divide"):
        tsodm._solve(KernelSpec(), X[:30], Y[:30], ODMParams(),
                     tsodm.SODMConfig(), 0)
