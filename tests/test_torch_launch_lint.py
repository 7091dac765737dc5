"""repro_torch.analysis.launch_lint (port of repro.analysis.jaxpr_lint):
fixtures that break each rule are flagged (a gather, an ``.item()``
inside a loop span, a collective inside an epoch span on a one-rank gloo
group, excess dispatches), allow-listed collectives pass, the lint costs
nothing when off, and the CPU sodm fit's dispatch plan per level and per
pass matches the level tracker's sweep counts — the same counts the
reference's solve reports on the same data."""
import numpy as np
import pytest
import torch

from repro_torch import observe
from repro_torch.analysis import invariants as inv
from repro_torch.analysis import launch_lint as ll
from repro_torch.kernels import gram as gram_mod
from repro_torch.observe import spans

from torch_dist_util import gloo_world


def _codes(violations):
    return sorted(v.rule for v in violations)


def test_gather_is_flagged_and_slices_are_not():
    x = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([2, 0, 1])
    assert _codes(ll.lint(lambda: x[idx], [ll.gather_free()])) == \
        ["gather_free"]
    assert _codes(ll.lint(lambda: torch.gather(x, 0, idx[:, None]),
                          [ll.gather_free()])) == ["gather_free"]
    assert ll.lint(lambda: x[1:3, ::2] + x[0, :2], [ll.gather_free()]) == []


def test_item_inside_loop_span_is_flagged():
    t = torch.ones(3)

    def loop():
        total = 0.0
        for i in range(3):
            with spans.span("loop", i=i):
                total += float(t.sum())          # host sync in the loop
        return total + t.max().item()            # outside: allowed

    bad = ll.lint(loop, [ll.no_host_sync_in("loop")])
    assert len(bad) == 3 and all("loop" in v.message for v in bad)
    assert ll.lint(lambda: t.sum().item(), [ll.no_host_sync_in("loop")]) \
        == []
    # with no span named, any host sync breaks the rule
    assert len(ll.lint(loop, [ll.no_host_sync_in(None)])) == 4


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    from repro_torch import sharding as shd
    with gloo_world(tmp_path_factory.mktemp("pg") / "store"):
        yield shd.make_mesh((1,), ("data",), "cpu")


def test_collective_in_epoch_span_detected(mesh):
    from repro_torch import sharding as shd
    t = torch.ones(4)

    def epochs():
        slab = shd.all_gather(t, mesh, "data")       # hoisted: fine
        for i in range(2):
            with spans.span("dsvrg.epoch", epoch=i):
                g = shd.all_gather(t, mesh, "data")  # the hoisting trap
                shd.psum(g.sum(), mesh, "data")      # per-epoch, allowed
        return slab

    sites = ll.record(epochs)
    bad = ll.lint(sites, [ll.no_collectives_in("dsvrg.epoch")])
    assert len(bad) == 4
    allowed = ll.lint(sites, [ll.no_collectives_in("dsvrg.epoch",
                                                   allow=("psum",))])
    assert len(allowed) == 2 and all("all_gather" in v.message
                                     for v in allowed)
    assert ll.count(sites, "all_gather", kind=ll.COLLECTIVE) == 3
    assert ll.lint(sites, [ll.no_collectives_in(
        "dsvrg.epoch", allow=("psum", "all_gather"))]) == []


def test_excess_dispatches_flagged():
    x = torch.randn(2, 8, 3)
    g = torch.ones(2, 8)

    def twice():
        gram_mod.gram_matvec(x, x, g, kind="rbf")
        with spans.span("pass"):
            gram_mod.gram_matvec(x, x, g, kind="rbf")

    sites = ll.record(twice)
    assert [s.name for s in sites if s.kind == ll.KERNEL] == \
        ["gram_matvec", "gram_matvec"]
    assert all(s.device == "cpu" and s.shapes[0] == (2, 8, 3)
               for s in sites if s.kind == ll.KERNEL)
    assert _codes(ll.lint(sites, [ll.max_launches("gram_matvec", 1)])) == \
        ["max_launches_gram_matvec_1"]
    assert ll.lint(sites, [ll.max_launches("gram_matvec", 1,
                                           within="pass")]) == []
    assert ll.lint(sites, [ll.expect_launches_per("pass", "gram_matvec",
                                                  1)]) == []
    assert ll.lint(sites, [ll.expect_launches_per("pass", "gram_matvec",
                                                  2)])
    assert ll.lint(sites, [ll.expect_launches_per("epoch", "gram_matvec",
                                                  1)])
    with pytest.raises(ll.InvariantViolation, match="budget is 1"):
        ll.check(sites, [ll.max_launches("gram_matvec", 1)], subject="x")


def test_recording_costs_nothing_when_off():
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    ll.record(lambda: torch.ones(2).sum().item())
    assert ll.ACTIVE is None and spans._LISTENER is None
    assert spans.current_recorder() is None
    assert _get_current_dispatch_mode() is None
    assert spans.span("x") is spans.span("y")        # the shared no-op
    assert spans.stack() == ()


def test_sodm_dispatch_plan_matches_level_sweeps():
    """Per level: one B8 (the level's Grams) and one fused pass a sweep,
    each K1 then K3 (dense Q at this size); the tracker's sweeps/level
    equal the recorded passes, and equal the reference's sweeps/level on
    the same data and partitions."""
    x, y = inv._toy_data(64, 4)
    mem = observe.InMemoryTracker()
    est = inv._estimator("sodm", "cpu", engine="pallas")
    (_, rep), sites = ll.run(lambda: est.fit(x, y, 0, tracker=mem))
    sweeps = [m["sweeps"] for _, m in mem.steps if "level" in m]
    assert sweeps == list(rep.passes)
    k1 = ll.per_span(sites, "cascade.level", "cd_block_sweep")
    k3 = ll.per_span(sites, "cascade.level", "dense_matvec")
    b8 = ll.per_span(sites, "cascade.level", "gram")
    assert [n for _, n in k1] == sweeps == [n for _, n in k3]
    assert [n for _, n in b8] == [1] * len(sweeps)
    assert [a["level"] for a, _ in k1] == sorted(
        (a["level"] for a, _ in k1), reverse=True)
    # every pass is K1 immediately followed by K3
    seq = [s.name for s in sites if s.kind == ll.KERNEL and s.name != "gram"]
    assert seq == ["cd_block_sweep", "dense_matvec"] * sum(sweeps)
    assert all(s.path[:2] == ("fit", "route.sodm")
               for s in sites if s.kind == ll.KERNEL)


def test_sodm_sweeps_equal_the_references():
    """The dispatch plan's per-level pass counts are the reference's
    sweeps/level on the same data and the same partitions."""
    import jax
    import jax.numpy as jnp
    from repro.core import kernel_fns as jkf
    from repro.core import odm as jodm
    from repro.core import sodm as jsodm
    from repro_torch.core import kernel_fns as tkf
    from repro_torch.core import odm as todm
    from repro_torch.core import sodm as tsodm
    rng = np.random.default_rng(3)
    M = 64
    x = np.concatenate([rng.standard_normal((M // 2, 4)) + 1.0,
                        rng.standard_normal((M // 2, 4)) - 1.0])
    y = np.concatenate([np.ones(M // 2), -np.ones(M // 2)])
    p = rng.permutation(M)
    x, y = x[p].astype(np.float32), y[p].astype(np.float32)
    kw = dict(p=2, levels=2, n_landmarks=4, tol=1e-4, max_sweeps=50,
              engine="pallas", block=8, partition_strategy="identity")
    jres = jsodm._solve(jkf.KernelSpec(name="rbf", gamma=0.5),
                        jnp.asarray(x), jnp.asarray(y),
                        jodm.ODMParams(1.0, 0.1, 0.5), jsodm.SODMConfig(**kw),
                        jax.random.PRNGKey(0))
    tres, sites = ll.run(lambda: tsodm._solve(
        tkf.KernelSpec(name="rbf", gamma=0.5), torch.tensor(x),
        torch.tensor(y), todm.ODMParams(1.0, 0.1, 0.5),
        tsodm.SODMConfig(**kw), 0))
    passes = [n for _, n in ll.per_span(sites, "cascade.level",
                                        "cd_block_sweep")]
    assert passes == list(tres.sweeps_per_level) == \
        [int(s) for s in jres.sweeps_per_level]
