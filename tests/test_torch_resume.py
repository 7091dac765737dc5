"""Chaos battery of the port: preemption-proof Algorithm-1 and DSVRG fits,
the fault plan, the checkpoint's crash window and async writer, and the
speculative scheduler — tests/test_resume.py and tests/test_straggler.py
ported to repro_torch at the same small sizes, plus cross-package checks
against the reference on the same numpy inputs.

Every kill test kills the fit with a deterministic fault plan, restarts
it through ``fit(resume=<dir>)`` and holds the resumed result to the
uninterrupted fit bit for bit (``torch.equal``), with fewer level solves
than a cold restart whenever a checkpoint was committed before the kill.
The level counter counts down from cfg.levels to 0; ``cascade.level``
fires before each level solve, so a kill at level k leaves level k+1's
checkpoint as the last committed state.
"""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ODMEstimator as JEstimator
from repro.api import ProblemSpec as JProblem
from repro.core import kernel_fns as jkf
from repro.core import sodm as jsodm
from repro.core.dsvrg import DSVRGConfig as JDSVRGConfig
from repro.distributed import faults as jfaults
from repro_torch.api import ODMEstimator, ProblemSpec
from repro_torch.core import dual_cd, odm, sodm
from repro_torch.core import kernel_fns as kf
from repro_torch.core.dsvrg import DSVRGConfig
from repro_torch.distributed import resume as resume_mod
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.faults import FaultPlan, Preemption
from repro_torch.distributed.straggler import SpecConfig, SpeculativeScheduler

pytestmark = pytest.mark.chaos


def _toy(M=32, d=4, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal((M // 2, d)) + 1.0,
                        rng.standard_normal((M // 2, d)) - 1.0])
    y = np.concatenate([np.ones(M // 2), -np.ones(M // 2)])
    perm = rng.permutation(M)
    return x[perm].astype(np.float32), y[perm].astype(np.float32)


def _cascade_cfg(levels, strategy="stratified"):
    return sodm.SODMConfig(p=2, levels=levels, n_landmarks=4, tol=1e-4,
                           max_sweeps=50, partition_strategy=strategy)


def _rbf_problem():
    return ProblemSpec(kernel=kf.KernelSpec(name="rbf", gamma=0.5))


def _fit(cfg, x, y, key=0, **kw):
    est = ODMEstimator(_rbf_problem(), route="sodm", cfg=cfg, device="cpu")
    return est.fit(x, y, key, **kw)


def _models_bit_identical(a, b):
    """FittedODM equality, bitwise, whichever representation is packed."""
    assert a.compression == b.compression
    for f in ("w", "x_sv", "coef"):
        fa, fb = getattr(a, f), getattr(b, f)
        assert (fa is None) == (fb is None), f
        if fa is not None:
            assert torch.equal(fa, fb), f
    return True


class TestCascadeKillAtLevel:
    @pytest.mark.parametrize("levels,kill_level,strategy", [
        (1, 0, "stratified"),
        (2, 1, "stratified"),
        (2, 0, "random"),
        (3, 2, "stratified"),
        (3, 1, "random"),
    ])
    def test_bit_identical_with_fewer_solves(self, tmp_path, levels,
                                             kill_level, strategy):
        x, y = _toy()
        cfg = _cascade_cfg(levels, strategy)
        base_model, base = _fit(cfg, x, y)

        d = str(tmp_path)
        with pytest.raises(Preemption) as exc:
            _fit(cfg, x, y, resume=d,
                 faults=FaultPlan().kill_at_level(kill_level))
        assert exc.value.site == "cascade.level"
        assert exc.value.info["level"] == kill_level

        c0 = sodm.level_solve_count()
        model, resumed = _fit(cfg, x, y, resume=d)
        ran = sodm.level_solve_count() - c0
        assert ran == kill_level + 1 < cfg.levels + 1
        assert torch.equal(resumed.raw.alpha, base.raw.alpha)
        assert resumed.raw.sweeps_per_level == base.raw.sweeps_per_level
        assert torch.equal(resumed.raw.kkt, base.raw.kkt)
        assert _models_bit_identical(model, base_model)

    def test_kill_at_top_level_cold_starts(self, tmp_path):
        x, y = _toy()
        cfg = _cascade_cfg(2)
        _, base = _fit(cfg, x, y)
        d = str(tmp_path)
        with pytest.raises(Preemption):
            _fit(cfg, x, y, resume=d,
                 faults=FaultPlan().kill_at_level(cfg.levels))
        c0 = sodm.level_solve_count()
        _, resumed = _fit(cfg, x, y, resume=d)
        assert sodm.level_solve_count() - c0 == cfg.levels + 1
        assert torch.equal(resumed.raw.alpha, base.raw.alpha)

    def test_completed_dir_resumes_with_zero_solves(self, tmp_path):
        x, y = _toy()
        cfg = _cascade_cfg(2)
        d = str(tmp_path)
        _, first = _fit(cfg, x, y, resume=d)
        c0 = sodm.level_solve_count()
        _, again = _fit(cfg, x, y, resume=d)
        assert sodm.level_solve_count() - c0 == 0
        assert torch.equal(again.raw.alpha, first.raw.alpha)

    def test_generator_key_fingerprinted_before_partitioning(self,
                                                             tmp_path):
        """A torch.Generator key resumes when handed over in the state the
        killed fit received it in (the partitioning consumes it)."""
        x, y = _toy()
        cfg = _cascade_cfg(2)
        gen = lambda: torch.Generator().manual_seed(3)     # noqa: E731
        _, base = _fit(cfg, x, y, key=gen())
        d = str(tmp_path)
        with pytest.raises(Preemption):
            _fit(cfg, x, y, key=gen(), resume=d,
                 faults=FaultPlan().kill_at_level(0))
        _, resumed = _fit(cfg, x, y, key=gen(), resume=d)
        assert torch.equal(resumed.raw.alpha, base.raw.alpha)
        spent = gen()
        torch.rand(1, generator=spent)
        with pytest.raises(resume_mod.ProvenanceError, match="key"):
            _fit(cfg, x, y, key=spent, resume=d)


class TestCascadeKillMidCheckpoint:
    def test_kill_inside_crash_window_then_resume(self, tmp_path):
        """The fit dies inside CheckpointManager._write (post-fsync,
        pre-rename) while committing the second level; step 1 survives,
        the torn write is left behind as a temp dir, and the resume
        restarts from step 1 bit-identically."""
        x, y = _toy()
        cfg = _cascade_cfg(2)
        _, base = _fit(cfg, x, y)
        d = str(tmp_path)
        with pytest.raises(Preemption) as exc:
            _fit(cfg, x, y, resume=d,
                 faults=FaultPlan().kill("checkpoint.pre_rename", step=2))
        assert exc.value.site == "checkpoint.pre_rename"
        assert CheckpointManager(d).all_steps() == [1]
        assert any(".tmp." in n for n in os.listdir(d))
        c0 = sodm.level_solve_count()
        _, resumed = _fit(cfg, x, y, resume=d)
        assert sodm.level_solve_count() - c0 == cfg.levels
        assert torch.equal(resumed.raw.alpha, base.raw.alpha)
        assert not any(".tmp." in n for n in os.listdir(d))


class TestProvenance:
    def test_strict_mismatch_raises(self, tmp_path):
        x, y = _toy()
        cfg = _cascade_cfg(2)
        d = str(tmp_path)
        with pytest.raises(Preemption):
            _fit(cfg, x, y, resume=d, faults=FaultPlan().kill_at_level(1))
        x2, y2 = _toy(seed=7)
        with pytest.raises(resume_mod.ProvenanceError, match="data"):
            _fit(cfg, x2, y2, resume=d)
        with pytest.raises(resume_mod.ProvenanceError, match="key"):
            _fit(cfg, x, y, key=1, resume=d)

    def test_lenient_mismatch_cold_starts(self, tmp_path):
        x, y = _toy()
        cfg = _cascade_cfg(2)
        d = str(tmp_path)
        with pytest.raises(Preemption):
            _fit(cfg, x, y, resume=d, faults=FaultPlan().kill_at_level(1))
        x2, y2 = _toy(seed=7)
        _, base2 = _fit(cfg, x2, y2)
        rc = resume_mod.ResumeConfig(directory=d, strict=False)
        with pytest.warns(RuntimeWarning, match="different run"):
            _, resumed = _fit(cfg, x2, y2, resume=rc)
        assert torch.equal(resumed.raw.alpha, base2.raw.alpha)

    def test_route_mismatch_raises(self, tmp_path):
        x, y = _toy()
        d = str(tmp_path)
        _fit(_cascade_cfg(1), x, y, resume=d)
        dcfg = sodm.SODMConfig(dsvrg=DSVRGConfig(n_partitions=4, epochs=2,
                                                 batch=8))
        est = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("linear")),
                           route="dsvrg", cfg=dcfg, device="cpu")
        with pytest.raises(resume_mod.ProvenanceError, match="cascade"):
            est.fit(x, y, 0, resume=d)


def _dsvrg_fit(cfg, x, y, **kw):
    est = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec(name="linear")),
                       route="dsvrg", cfg=cfg, device="cpu")
    return est.fit(x, y, 0, **kw)


class TestDsvrgResume:
    @pytest.mark.parametrize("schedule", ["serial", "parallel"])
    def test_resume_determinism(self, tmp_path, schedule):
        """Killed before the segment at epoch 2 of 4; the resumed w and
        history equal the uninterrupted fit's bit for bit."""
        x, y = _toy()
        dcfg = DSVRGConfig(n_partitions=4, epochs=4, batch=8,
                           n_landmarks=4, schedule=schedule)
        cfg = sodm.SODMConfig(p=2, levels=2, n_landmarks=4, tol=1e-4,
                              max_sweeps=50, dsvrg=dcfg)
        model_a, rep_a = _dsvrg_fit(cfg, x, y)
        d = str(tmp_path)
        with pytest.raises(Preemption) as exc:
            _dsvrg_fit(cfg, x, y, resume=d,
                       faults=FaultPlan().kill_at_epoch(2))
        assert exc.value.site == "dsvrg.segment"
        assert CheckpointManager(d).all_steps() == [1, 2]
        model_b, rep_b = _dsvrg_fit(cfg, x, y, resume=d)
        assert torch.equal(model_a.w, model_b.w)
        assert torch.equal(rep_a.raw.history, rep_b.raw.history)
        assert float(rep_a.raw.eta) == float(rep_b.raw.eta)

    def test_segment_width_preserves_result(self, tmp_path):
        x, y = _toy()
        dcfg = DSVRGConfig(n_partitions=4, epochs=4, batch=8, n_landmarks=4)
        cfg = sodm.SODMConfig(p=2, levels=2, n_landmarks=4, tol=1e-4,
                              max_sweeps=50, dsvrg=dcfg)
        ref, rep = _dsvrg_fit(cfg, x, y)
        for seg in (1, 2, 4):
            rc = resume_mod.ResumeConfig(
                directory=str(tmp_path / f"s{seg}"), segment=seg)
            m, r = _dsvrg_fit(cfg, x, y, resume=rc)
            assert torch.equal(ref.w, m.w), seg
            assert torch.equal(rep.raw.history, r.raw.history), seg
            assert CheckpointManager(rc.directory).latest_step() == 4


class TestFaultPlanBookkeeping:
    def test_fired_log_and_spent_rules(self):
        plan = FaultPlan(sleeper=None).delay("cascade.partition", 0.25,
                                            partition=1).kill_at_level(0)
        assert plan.site("cascade.partition", partition=0, attempt=1) == 0.0
        assert plan.site("cascade.partition", partition=1, attempt=1) == 0.25
        assert plan.site("cascade.partition", partition=1, attempt=2) == 0.0
        with pytest.raises(Preemption):
            plan.site("cascade.level", level=0, K=1)
        assert [(f[0], f[1]) for f in plan.fired] == [
            ("delay", "cascade.partition"), ("kill", "cascade.level")]

    def test_fired_log_equals_reference(self):
        """The same rules and the same site sequence, every verb: the
        same delays, the same kills and the same fired log."""
        def build(P):
            return (P(sleeper=None).kill_at_level(2, count=2)
                    .kill_mid_checkpoint().delay_partition(1, 0.5)
                    .kill_at_epoch(3).kill_at_shard(4)
                    .delay_shard_read(2, 0.125, count=3)
                    .delay("serve.flush", 0.01, batch=8))

        visits = ([("cascade.level", dict(level=lv, K=2 ** lv))
                   for lv in (3, 2, 2, 2, 1)]
                  + [("checkpoint.pre_rename", dict(step=s)) for s in (1, 2)]
                  + [("cascade.partition", dict(partition=p, attempt=a))
                     for p in range(3) for a in (1, 2)]
                  + [("dsvrg.segment", dict(epoch=e)) for e in range(5)]
                  + [("data.prefetch", dict(shard=s)) for s in (1, 2, 2, 2,
                                                                 2)]
                  + [("cascade.shard", dict(shard=s)) for s in range(6)]
                  + [("serve.flush", dict(batch=b)) for b in (3, 8, 8)])
        out = []
        for P, E in ((FaultPlan, Preemption), (jfaults.FaultPlan,
                                               jfaults.Preemption)):
            plan, seen = build(P), []
            for name, info in visits:
                try:
                    seen.append(plan.site(name, **info))
                except E as e:
                    seen.append(("killed", e.site, e.info))
            out.append((seen, plan.fired, repr(plan)))
        assert out[0] == out[1]

    def test_sleeper_gets_the_delay(self):
        slept = []
        plan = FaultPlan(sleeper=slept.append).delay("serve.flush", 0.5)
        assert plan.site("serve.flush", batch=1) == 0.5
        assert slept == [0.5]

    def test_non_instrumented_route_rejects_hooks(self):
        x, y = _toy()
        est = ODMEstimator(_rbf_problem(), route="cascade",
                           cfg=_cascade_cfg(1), device="cpu")
        with pytest.raises(ValueError, match="no .*seam"):
            est.fit(x, y, 0, faults=FaultPlan())
        jest = JEstimator(JProblem(kernel=jkf.KernelSpec("rbf", 0.5)),
                          route="cascade", cfg=jsodm.SODMConfig(levels=1))
        with pytest.raises(ValueError, match="no .*seam"):
            jest.fit(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
                     faults=jfaults.FaultPlan())


class TestCheckpointAsyncAndCrashWindow:
    def test_save_async_snapshots_on_the_caller_thread(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep=0)
        w = torch.arange(4.0)
        m.save_async(1, {"w": w}, {"epoch": 1})
        w.add_(100.0)                 # a later in-place update
        m.save_async(2, {"w": w})     # waits for step 1 first
        m.wait()
        assert m.all_steps() == [1, 2]
        assert torch.equal(m.restore({"w": None}, 1)["w"], torch.arange(4.0))
        assert torch.equal(m.restore({"w": None}, 2)["w"],
                           torch.arange(4.0) + 100.0)
        assert m.metadata(1)["metadata"] == {"epoch": 1}

    def test_wait_raises_the_writer_error(self, tmp_path):
        plan = FaultPlan().kill_mid_checkpoint()
        m = CheckpointManager(str(tmp_path), faults=plan)
        m.save_async(1, {"w": torch.ones(2)})
        with pytest.raises(Preemption, match="checkpoint.pre_rename"):
            m.wait()
        m.wait()                      # the error is raised once
        assert m.all_steps() == []
        m.save_async(1, {"w": torch.ones(2)})     # the rule is spent
        m.wait()
        assert m.all_steps() == [1]
        assert not any(".tmp." in n for n in os.listdir(tmp_path))

    def test_crash_window_keeps_the_committed_step(self, tmp_path):
        plan = FaultPlan().kill("checkpoint.pre_rename", step=2)
        m = CheckpointManager(str(tmp_path), keep=3, faults=plan)
        m.save(1, {"w": torch.zeros(3)})
        with pytest.raises(Preemption) as exc:
            m.save(2, {"w": torch.ones(3)})
        assert exc.value.info == {"step": 2}
        assert m.all_steps() == [1]
        assert torch.equal(m.restore({"w": None})["w"], torch.zeros(3))
        assert sum(".tmp." in n for n in os.listdir(tmp_path)) == 1


class TestAgainstReference:
    def test_resumed_identity_fit_matches_reference_duals(self, tmp_path):
        """Identity partitions lay out the same rows in both packages:
        the port's killed-and-resumed fit lies within 1e-5 of the
        reference's uninterrupted duals."""
        x, y = _toy(M=64, d=6, seed=2)
        cfg = _cascade_cfg(2, "identity")
        jcfg = jsodm.SODMConfig(p=2, levels=2, n_landmarks=4, tol=1e-4,
                                max_sweeps=50, partition_strategy="identity")
        _, jrep = JEstimator(JProblem(kernel=jkf.KernelSpec("rbf", 0.5)),
                             route="sodm", cfg=jcfg).fit(
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        d = str(tmp_path)
        with pytest.raises(Preemption):
            _fit(cfg, x, y, resume=d, faults=FaultPlan().kill_at_level(1))
        _, rep = _fit(cfg, x, y, resume=d)
        want = np.asarray(jrep.raw.alpha)
        assert np.abs(rep.raw.alpha.numpy() - want).max() <= 1e-5
        assert list(rep.passes) == list(jrep.passes)

    def test_resumed_dsvrg_matches_reference(self, tmp_path):
        x, y = _toy(M=64, d=6, seed=2)
        dcfg = DSVRGConfig(n_partitions=4, epochs=4, batch=8,
                           partition_strategy="identity")
        jdcfg = JDSVRGConfig(n_partitions=4, epochs=4, batch=8,
                             partition_strategy="identity")
        cfg = sodm.SODMConfig(partition_strategy="identity", dsvrg=dcfg)
        jcfg = jsodm.SODMConfig(partition_strategy="identity", dsvrg=jdcfg)
        jm, _ = JEstimator(JProblem(kernel=jkf.KernelSpec("linear")),
                           route="dsvrg", cfg=jcfg).fit(
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        d = str(tmp_path)
        with pytest.raises(Preemption):
            _dsvrg_fit(cfg, x, y, resume=d,
                       faults=FaultPlan().kill_at_epoch(3))
        m, _ = _dsvrg_fit(cfg, x, y, resume=d)
        want = np.asarray(jm.w)
        rel = np.abs(m.w.numpy() - want).max() / np.abs(want).max()
        assert rel <= 1e-5

    def test_layout_and_metadata_keys_are_the_reference(self, tmp_path):
        x, y = _toy()
        cfg = _cascade_cfg(2, "identity")
        jcfg = jsodm.SODMConfig(p=2, levels=2, n_landmarks=4, tol=1e-4,
                                max_sweeps=50, partition_strategy="identity")
        dp, dj = str(tmp_path / "port"), str(tmp_path / "ref")
        _fit(cfg, x, y, resume=dp)
        JEstimator(JProblem(kernel=jkf.KernelSpec("rbf", 0.5)),
                   route="sodm", cfg=jcfg).fit(
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
            resume=dj)
        assert sorted(os.listdir(dp)) == sorted(os.listdir(dj))
        for step in sorted(os.listdir(dp)):
            mp, mj = (json.load(open(os.path.join(r, step, "manifest.json")))
                      for r in (dp, dj))
            # the same leaves and shapes (the port's perm is int64, the
            # reference's int32)
            assert {k: v["shape"] for k, v in mp["leaves"].items()} == \
                {k: v["shape"] for k, v in mj["leaves"].items()}
            a, b = mp["metadata"], mj["metadata"]
            assert sorted(a) == sorted(b)
            for k in ("route", "level", "K", "m", "sweeps_per_level"):
                assert a[k] == b[k], k
            pa, pb = a["provenance"], b["provenance"]
            assert sorted(pa) == sorted(pb)
            assert sorted(pa["data"]) == sorted(pb["data"])
            for k in ("shape", "dtype"):
                assert pa["data"][k] == pb["data"][k]
        # the streaming provenance fingerprints the source with the
        # reference's keys, and a dense level directory does not feed a
        # streaming fit (nor the other way round)
        from repro.data import streaming as jds
        from repro.distributed import resume as jresume
        from repro_torch.data import streaming as tds
        prov = resume_mod.provenance_source(
            kf.KernelSpec("rbf", 0.5), odm.ODMParams(), cfg,
            tds.ArraySource(x, y, 16), 0)
        jprov = jresume.provenance_source(
            jkf.KernelSpec("rbf", 0.5), None, jcfg,
            jds.ArraySource(x, y, 16), jax.random.PRNGKey(0))
        assert sorted(prov) == sorted(jprov)
        assert prov["data"] == jprov["data"]
        mgr = resume_mod.CascadeResumeManager(
            resume_mod.ResumeConfig(dp), {})
        with pytest.raises(resume_mod.ProvenanceError, match="'level'"):
            mgr.restore_stream()


class TestScheduler:
    def test_results_in_order(self):
        sched = SpeculativeScheduler(SpecConfig(max_workers=4))
        tasks = [lambda i=i: i * i for i in range(10)]
        assert sched.run(tasks) == [i * i for i in range(10)]

    def test_straggler_gets_duplicated(self):
        attempts = {"n": 0}
        lock = threading.Lock()

        def straggler():
            with lock:
                attempts["n"] += 1
                first = attempts["n"] == 1
            if first:
                time.sleep(5.0)       # pathological first attempt
            return "done"

        tasks = [lambda: (time.sleep(0.01) or "fast") for _ in range(7)]
        tasks.append(straggler)
        sched = SpeculativeScheduler(SpecConfig(
            max_workers=4, spec_quantile=0.5, spec_factor=2.0))
        t0 = time.monotonic()
        out = sched.run(tasks)
        dt = time.monotonic() - t0
        assert out[-1] == "done"
        assert dt < 4.0, f"speculation failed to rescue ({dt:.1f}s)"
        assert attempts["n"] >= 2

    def test_failed_attempt_retried(self):
        state = {"fails": 0}
        lock = threading.Lock()

        def flaky():
            with lock:
                state["fails"] += 1
                if state["fails"] == 1:
                    raise RuntimeError("transient")
            return 42

        sched = SpeculativeScheduler(SpecConfig(max_workers=2))
        assert sched.run([flaky]) == [42]

    def test_partition_site_kill_is_retried(self):
        plan = FaultPlan(sleeper=None).kill("cascade.partition",
                                            partition=1)
        sched = SpeculativeScheduler(SpecConfig(max_workers=2))
        assert sched.run([lambda: 1, lambda: 2], faults=plan) == [1, 2]
        assert plan.fired == [("kill", "cascade.partition",
                               {"partition": 1, "attempt": 1})]

    def test_idempotent_partition_solve(self):
        """Duplicated partition solves give identical results (a pure
        function of the inputs), so first-wins is safe."""
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((32, 4)).astype(np.float32))
        y = torch.sign(torch.from_numpy(
            rng.standard_normal(32).astype(np.float32)))
        Q = kf.signed_gram(kf.KernelSpec("rbf", 0.5), x, y)
        p = odm.ODMParams()

        def solve_task():
            return dual_cd.solve(Q, p, mscale=32.0, tol=1e-6).alpha

        outs = SpeculativeScheduler(SpecConfig(max_workers=4)).run(
            [solve_task] * 4)
        for o in outs[1:]:
            assert torch.equal(outs[0], o)
