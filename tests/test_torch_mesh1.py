"""The port's SPMD drivers on a one-rank ``gloo`` mesh against the
reference's on its one-device mesh (``tests/test_dsvrg.py::_mesh1``).

In process: one world of size 1 for the whole file (a ``FileStore``
under the test's temporary directory), destroyed at teardown. The
sharded Algorithm-1 solve takes the reference's permutation (its
sharded path draws a stratified one with a JAX key; the port's first
rank draws it, so the test patches the port's draw); the sharded DSVRG
uses the ``identity`` strategy on both sides. Bands: 1e-5 for the duals,
the port's DSVRG band (1e-5 relative) for w and the history. Then the
reference's own regressions for the sharded DSVRG
(``tests/test_dsvrg.py``: the auto step size of ``make_sharded_epoch``,
the on-device global history, sharded against one-process parity on both
schedules, the AUTO route's parallel-schedule upgrade on a mesh).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro import sharding as jshd
from repro.core import dsvrg as jd, kernel_fns as jkf, odm as jodm
from repro.core import sodm as jsodm
from repro_torch.analysis.invariants import counter
from repro_torch.api import ODMEstimator, ProblemSpec
from repro_torch.core import dsvrg as td, kernel_fns as tkf, odm as todm
from repro_torch.core import sodm as tsodm
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import model as tmodel
from repro_torch.serve import server

from torch_dist_util import gloo_world

PARAMS = (1.0, 0.1, 0.5)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    with gloo_world(tmp_path_factory.mktemp("pg") / "store"):
        yield make_host_mesh((1,), ("data",))


def _data(seed=0, M=128, d=5):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal((M // 2, d)) + 0.7,
                        rng.standard_normal((M // 2, d)) - 0.7])
    y = np.concatenate([np.ones(M // 2), -np.ones(M // 2)])
    p = rng.permutation(M)
    return x[p].astype(np.float32), y[p].astype(np.float32)


def _rel(t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def _jmesh1():
    return jshd.make_mesh((1,), ("data",))


def _counts():
    return {op: counter(f"collective.{op}").count
            for op in ("psum", "pmean", "all_gather", "broadcast")}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


@pytest.mark.parametrize("engine", ["scalar", "pallas"])
def test_sodm_solve_sharded_matches_reference(engine, mesh, monkeypatch):
    x, y = _data()
    kw = dict(p=2, levels=3, n_landmarks=4, tol=1e-6, max_sweeps=300,
              engine=engine, block=8)
    jr = jsodm._solve_sharded(jkf.KernelSpec("rbf", gamma=0.5),
                              jnp.asarray(x), jnp.asarray(y),
                              jodm.ODMParams(), jsodm.SODMConfig(**kw),
                              jax.random.PRNGKey(3), _jmesh1())
    perm = torch.tensor(np.asarray(jr.perm), dtype=torch.int64)
    monkeypatch.setattr(tsodm, "_sharded_perm", lambda *a: perm)
    before = _counts()
    tr = tsodm._solve_sharded(tkf.KernelSpec("rbf", gamma=0.5),
                              torch.tensor(x), torch.tensor(y),
                              todm.ODMParams(), tsodm.SODMConfig(**kw), 3,
                              mesh)
    np.testing.assert_array_equal(tr.perm.numpy(), np.asarray(jr.perm))
    np.testing.assert_allclose(tr.alpha.numpy(), np.asarray(jr.alpha),
                               rtol=0, atol=1e-5)
    assert tr.sweeps_per_level == jr.sweeps_per_level
    # one rank: every level is replicated (no gather), one perm broadcast
    assert _delta(before) == dict(psum=0, pmean=0, all_gather=0,
                                  broadcast=1)


@pytest.mark.parametrize("batch", [4, 3], ids=["even", "ragged"])
@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_dsvrg_solve_sharded_matches_reference(schedule, batch, mesh):
    """K = 8 partitions of 16, 4 epochs, the auto step size; batch 3
    leaves a ragged tail. The collectives follow the reference's
    pattern: one psum of ‖x‖² a solve, one anchor-gradient psum and one
    objective psum an epoch, one pmean an epoch on the parallel schedule,
    and one slab gather a solve on the serial one."""
    x, y = _data()
    kw = dict(n_partitions=8, epochs=4, batch=batch, schedule=schedule,
              partition_strategy="identity")
    jr = jd._solve_sharded(jnp.asarray(x), jnp.asarray(y),
                           jodm.ODMParams(*PARAMS), jd.DSVRGConfig(**kw),
                           jax.random.PRNGKey(4), _jmesh1())
    before = _counts()
    tr = td._solve_sharded(torch.tensor(x), torch.tensor(y),
                           todm.ODMParams(*PARAMS), td.DSVRGConfig(**kw), 4,
                           mesh)
    assert _rel(tr.w, jr.w) <= 1e-5
    assert _rel(tr.history, jr.history) <= 1e-5
    assert float(tr.eta) == pytest.approx(float(jr.eta), rel=1e-6)
    par = schedule == "parallel"
    assert _delta(before) == dict(psum=1 + 2 * 4, pmean=4 if par else 0,
                                  all_gather=0 if par else 1, broadcast=1)


def test_make_sharded_epoch_auto_eta_matches_reference(mesh):
    x, y = _data(M=128, d=5)
    params = (4.0, 0.1, 0.5)
    cfg = dict(n_partitions=8, epochs=1, batch=4)
    xs, ys = x.reshape(8, 16, 5), y.reshape(8, 16)
    jw, jobj = jd.make_sharded_epoch(_jmesh1(), jodm.ODMParams(*params),
                                     jd.DSVRGConfig(**cfg), 128)(
        jnp.zeros(5), jnp.asarray(xs), jnp.asarray(ys))
    tw, tobj = td.make_sharded_epoch(mesh, todm.ODMParams(*params),
                                     td.DSVRGConfig(**cfg), 128)(
        torch.zeros(5), torch.tensor(xs), torch.tensor(ys))
    assert _rel(tw, jw) <= 1e-5
    assert float(tobj) == pytest.approx(float(jobj), rel=1e-5)


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_score_sharded_matches_reference(kernel, mesh):
    x, y = _data(M=96, d=5)
    rng = np.random.default_rng(5)
    alpha = np.abs(rng.standard_normal(2 * 96)).astype(np.float32)
    alpha[rng.random(2 * 96) < 0.3] = 0.0
    jm = jserve.model.compile_model(jkf.KernelSpec(kernel, gamma=0.5),
                                    jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(alpha))
    tm = tmodel.compile_model(tkf.KernelSpec(kernel, gamma=0.5),
                              torch.tensor(x), torch.tensor(y),
                              torch.tensor(alpha))
    want = np.asarray(jserve.score_sharded(jm, jnp.asarray(x[:48]),
                                           _jmesh1()))
    before = _counts()
    got = server.score_sharded(tm, x[:48], mesh)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    # the slab is cached per (model, mesh): a second call reuses it
    again = server.score_sharded(tm, x[:48], mesh)
    assert torch.equal(got, again)
    assert _delta(before)["psum"] == (0 if kernel == "linear" else 2)


# ---------------------------------------------------------------------------
# the reference's regressions for the sharded DSVRG (tests/test_dsvrg.py)
# ---------------------------------------------------------------------------

def test_sharded_epoch_uses_auto_eta(mesh):
    """make_sharded_epoch takes the auto step, not a fixed 0.05."""
    x, y = _data(M=128, d=5)
    params = todm.ODMParams(lam=4.0, theta=0.1, ups=0.5)
    cfg = td.DSVRGConfig(n_partitions=8, epochs=1, batch=4)
    xs, ys = torch.tensor(x).reshape(8, 16, 5), torch.tensor(y).reshape(8, 16)
    w0 = torch.zeros(5)
    eta_ref = td.auto_eta(torch.tensor(x), params)
    assert abs(eta_ref - 0.05) > 1e-3
    w_auto, _ = td.make_sharded_epoch(mesh, params, cfg, 128)(w0, xs, ys)
    w_explicit, _ = td.make_sharded_epoch(mesh, params, cfg, 128,
                                          eta=eta_ref)(w0, xs, ys)
    w_old_bug, _ = td.make_sharded_epoch(mesh, params, cfg, 128,
                                         eta=0.05)(w0, xs, ys)
    assert torch.allclose(w_auto, w_explicit, atol=1e-6)
    assert not torch.allclose(w_auto, w_old_bug, atol=1e-6)


def test_sharded_and_single_process_same_step_size(mesh):
    x, y = _data(M=128, d=5)
    cfg = td.DSVRGConfig(n_partitions=8, epochs=2, batch=4)
    p = todm.ODMParams(*PARAMS)
    r1 = td._solve(torch.tensor(x), torch.tensor(y), p, cfg, 0)
    r2 = td._solve_sharded(torch.tensor(x), torch.tensor(y), p, cfg, 0,
                           mesh)
    assert float(r1.eta) == pytest.approx(float(r2.eta), rel=1e-6)
    assert float(r1.eta) == pytest.approx(
        td.auto_eta(torch.tensor(x), p), rel=1e-5)


def test_sharded_history_is_global_objective(mesh):
    x, y = _data(M=128, d=5)
    cfg = td.DSVRGConfig(n_partitions=8, epochs=3, batch=4)
    p = todm.ODMParams(*PARAMS)
    res = td._solve_sharded(torch.tensor(x), torch.tensor(y), p, cfg, 0,
                            mesh)
    X, Y = torch.tensor(x)[res.perm], torch.tensor(y)[res.perm]
    host_obj = float(todm.primal_objective(res.w, X, Y, p))
    assert abs(float(res.history[-1]) - host_obj) < 1e-5


@pytest.mark.parametrize("batch", [4, 3], ids=["even", "ragged"])
@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_sharded_matches_single_process(schedule, batch, mesh):
    """One rank: the sharded solve is the one-process solve bit for bit
    in w (same perm, same reductions), the history within an ulp (it is
    psum(loss − ridge) + ridge)."""
    x, y = _data(M=128, d=5)
    cfg = td.DSVRGConfig(n_partitions=8, epochs=4, batch=batch,
                         schedule=schedule)
    p = todm.ODMParams(*PARAMS)
    r1 = td._solve(torch.tensor(x), torch.tensor(y), p, cfg, 4)
    r2 = td._solve_sharded(torch.tensor(x), torch.tensor(y), p, cfg, 4,
                           mesh)
    assert torch.equal(r1.perm, r2.perm)
    assert torch.equal(r1.w, r2.w)
    torch.testing.assert_close(r1.history, r2.history, rtol=1e-6, atol=0)


def test_auto_route_on_mesh_prefers_parallel_schedule(mesh, monkeypatch):
    """An AUTO-dispatched sharded solve upgrades the serial schedule to
    parallel; an explicit engine="dsvrg" keeps the configured one."""
    x, y = _data(M=128, d=5)
    spec = tkf.KernelSpec(name="linear")
    base = td.DSVRGConfig(n_partitions=8, epochs=2, batch=8)
    assert base.schedule == "serial"
    seen = []
    real = td._solve_sharded

    def spy(x, y, params, cfg, *a, **k):
        seen.append(cfg.schedule)
        return real(x, y, params, cfg, *a, **k)

    monkeypatch.setattr(td, "_solve_sharded", spy)
    X, Y, p = torch.tensor(x), torch.tensor(y), todm.ODMParams(*PARAMS)
    tsodm._solve_sharded(spec, X, Y, p,
                         tsodm.SODMConfig(dsvrg_threshold=64, dsvrg=base), 0,
                         mesh)
    tsodm._solve_sharded(spec, X, Y, p,
                         tsodm.SODMConfig(engine="dsvrg", dsvrg=base), 0,
                         mesh)
    assert seen == ["parallel", "serial"]
    # the estimator's AUTO rule: route=None upgrades, route="dsvrg" keeps
    seen.clear()
    cfg = tsodm.SODMConfig(dsvrg_threshold=64, dsvrg=base)
    for route in (None, "dsvrg"):
        ODMEstimator(ProblemSpec(kernel=spec), route=route, cfg=cfg,
                     mesh=mesh).fit(x, y, 0)
    assert seen == ["parallel", "serial"]


def test_estimator_on_mesh_matches_reference(mesh, monkeypatch):
    """ODMEstimator(mesh=...) for route="sodm", "dsvrg" and None against
    the reference's estimator on its one-device mesh."""
    x, y = _data()
    from repro.api import ODMEstimator as JEst, ProblemSpec as JProb
    scfg = dict(p=2, levels=3, n_landmarks=4, tol=1e-6, max_sweeps=300)
    jm, jrep = JEst(JProb(kernel=jkf.KernelSpec("rbf", gamma=0.5)),
                    route="sodm", cfg=jsodm.SODMConfig(**scfg),
                    mesh=_jmesh1()).fit(jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(3))
    perm = torch.tensor(np.asarray(jrep.raw.perm), dtype=torch.int64)
    monkeypatch.setattr(tsodm, "_sharded_perm", lambda *a: perm)
    tm, trep = ODMEstimator(ProblemSpec(kernel=tkf.KernelSpec("rbf",
                                                               gamma=0.5)),
                            route="sodm", cfg=tsodm.SODMConfig(**scfg),
                            mesh=mesh).fit(x, y, 3)
    assert trep.route == "sodm" and trep.passes == jrep.passes
    np.testing.assert_allclose(trep.raw.alpha.numpy(),
                               np.asarray(jrep.raw.alpha), rtol=0,
                               atol=1e-5)
    f_t = tm.decision_function(x[:32]).numpy()
    f_j = np.asarray(jm.decision_function(jnp.asarray(x[:32])))
    assert np.abs(f_t - f_j).max() <= 1e-5 * np.abs(f_j).max()
    dcfg = dict(n_partitions=8, epochs=3, batch=4,
                partition_strategy="identity")
    for route in ("dsvrg", None):
        jcfg = jsodm.SODMConfig(dsvrg_threshold=64,
                                partition_strategy="identity",
                                dsvrg=jd.DSVRGConfig(**dcfg))
        tcfg = tsodm.SODMConfig(dsvrg_threshold=64,
                                partition_strategy="identity",
                                dsvrg=td.DSVRGConfig(**dcfg))
        jm, jrep = JEst(JProb(kernel=jkf.KernelSpec("linear")), route=route,
                        cfg=jcfg, mesh=_jmesh1()).fit(
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        tm, trep = ODMEstimator(ProblemSpec(kernel=tkf.KernelSpec("linear")),
                                route=route, cfg=tcfg, mesh=mesh).fit(x, y, 0)
        assert trep.route == jrep.route == "dsvrg"
        assert _rel(tm.w, jm.w) <= 1e-5
        assert _rel(trep.history, jrep.history) <= 1e-5


def test_mesh_refused_where_the_reference_refuses(mesh):
    """A mesh on a mesh-unaware route, or with a streaming source, raises
    the reference's ValueError."""
    from repro.api import registry as jreg
    from repro_torch.api import registry as treg
    for name in ("cascade", "dip", "dc", "svrg", "csvrg"):
        kern = "linear" if name in ("svrg", "csvrg") else "rbf"
        with pytest.raises(ValueError) as te:
            treg.get(name).check(kern, 128, mesh)
        with pytest.raises(ValueError) as je:
            jreg.get(name).check(kern, 128, _jmesh1())
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        treg.get("dsvrg").check("linear", 128, mesh, streaming=True)
    with pytest.raises(ValueError) as je:
        jreg.get("dsvrg").check("linear", 128, _jmesh1(), streaming=True)
    assert str(te.value) == str(je.value)


def test_collectives_count_bytes_and_open_host_spans(mesh):
    """Each collective bumps collective.<op> and its bytes, and opens a
    host span of the same name when a recorder is installed."""
    from repro_torch import sharding
    from repro_torch.observe import spans
    x = torch.arange(6, dtype=torch.float32)
    before = {k: counter(f"collective.{k}").count for k in
              ("psum", "pmean", "all_gather", "broadcast", "barrier")}
    nbytes = counter("collective.all_gather.bytes").count
    rec = spans.SpanRecorder()
    with spans.install(rec):
        assert torch.equal(sharding.psum(x, mesh, "data"), x)
        assert torch.equal(sharding.pmean(x, mesh, "data"), x)
        g = sharding.all_gather(-x, mesh, "data")
        assert torch.equal(torch.signbit(g), torch.signbit(-x))
        sharding.broadcast(x, mesh)
        assert sharding.mesh_all_ok(mesh, True)
        assert not sharding.mesh_all_ok(mesh, False)
    for op, n in before.items():
        want = 2 if op == "barrier" else 1
        assert counter(f"collective.{op}").count - n == want
        assert len(rec.spans(f"collective.{op}")) == want
    assert counter("collective.all_gather.bytes").count - nbytes == 24


def test_production_mesh_takes_its_shape_from_the_world(mesh):
    """One rank cannot split into two pods; the single-pod mesh is
    (world, 1) on ("data", "model") (made on the card, so only its
    refusal runs here)."""
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="two pods"):
        make_production_mesh(multi_pod=True)


def test_checkpoint_of_dtensor_leaves_on_one_rank(mesh, tmp_path):
    """save of DTensor leaves writes their full values (the first rank
    writes); restore(shardings=) places them back on the mesh;
    save_async refuses them."""
    from repro_torch import sharding
    from repro_torch.distributed import elastic
    from repro_torch.distributed.checkpoint import CheckpointManager
    tree = {"w": torch.arange(12.0).reshape(4, 3), "s": torch.tensor(2)}
    axes = {"w": ("batch", None), "s": ()}
    placed = elastic.reshard(tree, axes, mesh)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, placed)
    back = mgr.restore(tree, shardings=sharding.tree_shardings(axes, tree,
                                                                mesh))
    assert elastic.validate_resharding(tree, back)
    assert torch.equal(mgr.restore(tree)["w"], tree["w"])
    with pytest.raises(ValueError, match="save_async"):
        mgr.save_async(2, placed)
