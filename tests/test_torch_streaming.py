"""repro_torch.data.streaming and the streamed fits against the reference.

The batteries of tests/test_streaming.py, each port function held against
its reference counterpart on the same numpy inputs:

* sources — the same shard bytes (``SyntheticSource`` included), sizes,
  read counters and fingerprints;
* loader — every shard in order, slabs bitwise invariant to the shard
  layout and equal to the reference's, ``start_row`` skipping shards
  unread, no aliasing of the carry buffer, per-shard label checks, the
  byte accountant's peak, ``data.prefetch`` kills and delays, the
  prefetch depth never above 2;
* one-pass partitioning — the reservoir equal to the reference's row for
  row, landmarks exact when the reservoir covers the data, strata equal
  to the dense ones and the reference's, assignment invariant to layout;
* streamed fits — the dsvrg stream against the reference's
  ``_solve_stream`` (the DSVRG band: relative 1e-2, prediction agreement
  0.99; the measured gap is printed, about 1e-6), the cascade stream
  against the reference's (1e-5); a source whose last slab holds fully
  padded minibatches matches the reference's masked chain and not the
  unmasked one;
* dispatch errors and, under the ``chaos`` marker, kills and resumes.

Small shapes (M <= 512, d <= 8); every fit runs on the CPU.
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
from repro.core import baselines as jb
from repro.core import dsvrg as jd
from repro.core import kernel_fns as jkf
from repro.core import odm as jodm
from repro.core import sodm as jsodm
from repro.data import streaming as jds
from repro.distributed import faults as jfaults
from repro.observe import MetricsRegistry as JMetrics
from repro.serve import model as jmodel
from repro_torch.api import ODMEstimator, ProblemSpec
from repro_torch.api import registry as treg
from repro_torch.core import baselines as tb
from repro_torch.core import dsvrg as td
from repro_torch.core import kernel_fns as kf
from repro_torch.core import odm
from repro_torch.core import partition
from repro_torch.core import sodm
from repro_torch.core.dsvrg import DSVRGConfig
from repro_torch.data import streaming as ds
from repro_torch.distributed import resume as resume_mod
from repro_torch.distributed.faults import FaultPlan, Preemption
from repro_torch.kernels import odm_grad as og
from repro_torch.observe.instruments import MetricsRegistry
from repro_torch.serve import model as tmodel

KEY = jax.random.PRNGKey(0)


def _data(M=256, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, d)).astype(np.float32)
    y = np.where(rng.random(M) < 0.5, -1.0, 1.0).astype(np.float32)
    return x, y


def _raw_pairs(x, y, directory, shard_rows):
    os.makedirs(directory, exist_ok=True)
    pairs = []
    for i, lo in enumerate(range(0, x.shape[0], shard_rows)):
        xp = str(directory / f"{i}_x.bin")
        yp = str(directory / f"{i}_y.bin")
        x[lo:lo + shard_rows].tofile(xp)
        y[lo:lo + shard_rows].tofile(yp)
        pairs.append((xp, yp))
    return pairs


def _layouts(x, y, tmp_path, mod=ds):
    """The same rows presented four ways (and four shard geometries), as
    ``mod``'s sources (the port's or the reference's) over the same
    files."""
    npy = tmp_path / "npy"
    if not npy.exists():
        ds.NpyShardSource.write(str(npy), x, y, shard_rows=64)
    pairs = [(str(npy / f"shard_{s:05d}_x.npy"),
              str(npy / f"shard_{s:05d}_y.npy"))
             for s in range(-(-x.shape[0] // 64))]
    return [
        mod.ArraySource(x, y, shard_rows=32),
        mod.ArraySource(x, y, shard_rows=48),     # straddles slab edges
        mod.NpyShardSource(pairs),
        mod.RawBinarySource(_raw_pairs(x, y, tmp_path / "raw", 80),
                            n_features=x.shape[1]),
    ]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

class TestSources:
    def test_protocol_and_duck_check(self, tmp_path):
        x, y = _data(64)
        for src in _layouts(x, y, tmp_path):
            assert isinstance(src, ds.ShardedSource)
            assert ds.is_source(src)
        assert not ds.is_source(torch.from_numpy(x))
        assert not ds.is_source(x)
        assert ds.__all__ == jds.__all__

    def test_shards_and_fingerprints_equal_the_reference(self, tmp_path):
        x, y = _data(192, 5)
        for t, j in zip(_layouts(x, y, tmp_path),
                        _layouts(x, y, tmp_path, jds), strict=True):
            assert t.shard_sizes() == j.shard_sizes()
            assert (t.n_rows, t.n_features, t.total_bytes) == \
                (j.n_rows, j.n_features, j.total_bytes)
            assert t.fingerprint() == j.fingerprint()
            for i in range(t.n_shards):
                (tx, ty), (jx, jy) = t.read_shard(i), j.read_shard(i)
                assert np.asarray(tx).tobytes() == np.asarray(jx).tobytes()
                assert np.asarray(ty).tobytes() == np.asarray(jy).tobytes()
            for src in (t, j):
                xm, ym = ds.materialize(src)
                np.testing.assert_array_equal(xm, x)
                np.testing.assert_array_equal(ym, y)
            assert t.reads == j.reads == [2] * t.n_shards

    def test_npy_write_lays_out_the_reference_files(self, tmp_path):
        x, y = _data(150, 3)
        t = ds.NpyShardSource.write(str(tmp_path / "t"), x, y, 64)
        j = jds.NpyShardSource.write(str(tmp_path / "j"), x, y, 64)
        assert t.shard_sizes() == j.shard_sizes() == (64, 64, 22)
        for (ta, tb_), (ja, jb_) in zip(t.pairs, j.pairs, strict=True):
            assert os.path.basename(ta) == os.path.basename(ja)
            for a, b in ((ta, ja), (tb_, jb_)):
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read()

    @pytest.mark.parametrize("seed,rows,shard", [(3, 1000, 256),
                                                 (0, 300, 300)])
    def test_synthetic_equals_the_reference_bit_for_bit(self, seed, rows,
                                                        shard):
        t = ds.SyntheticSource(rows, 8, shard_rows=shard, seed=seed,
                               sep=1.5)
        j = jds.SyntheticSource(rows, 8, shard_rows=shard, seed=seed,
                                sep=1.5)
        assert t.fingerprint() == j.fingerprint()
        for i in range(t.n_shards):
            (tx, ty), (jx, jy) = t.read_shard(i), j.read_shard(i)
            assert tx.tobytes() == jx.tobytes()
            assert ty.tobytes() == jy.tobytes()
        assert t.read_shard(0)[0].tobytes() != ds.SyntheticSource(
            rows, 8, shard_rows=shard, seed=seed + 1).read_shard(0)[0] \
            .tobytes()

    def test_read_counters_and_bounds(self):
        x, y = _data(96)
        src = ds.ArraySource(x, y, shard_rows=32)
        assert src.reads == [0, 0, 0]
        src.read_shard(1)
        src.read_shard(1)
        assert src.reads == [0, 2, 0]
        with pytest.raises(IndexError, match="out of range"):
            src.read_shard(3)
        with pytest.raises(ValueError, match="positive"):
            ds.ArraySource(x, y, shard_rows=0)

    def test_validate_source(self):
        x, y = _data(64)
        spec = ProblemSpec()
        spec.validate_source(ds.ArraySource(x, y, shard_rows=16))

        class Hollow:
            n_rows, n_features = 0, 4

            def shard_sizes(self):
                return ()

            def read_shard(self, i):
                raise AssertionError

        with pytest.raises(ValueError, match="empty"):
            spec.validate_source(Hollow())

        class Lying(Hollow):
            n_rows = 10

            def shard_sizes(self):
                return (4, 4)

        with pytest.raises(ValueError, match="inconsistent"):
            spec.validate_source(Lying())


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

class TestLoader:
    def test_prefetch_yields_every_shard_in_order(self):
        x, y = _data(160)
        src = ds.ArraySource(x, y, shard_rows=32)
        mets = MetricsRegistry()
        got = list(ds.PrefetchLoader(src, depth=2, metrics=mets))
        assert [i for i, *_ in got] == [0, 1, 2, 3, 4]
        np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), x)
        assert src.reads == [1] * 5
        snap = mets.snapshot()
        assert snap["data.rows.count"] == 160
        assert snap["data.shard.read_s.count"] == 5
        assert snap["data.prefetch.depth.max"] <= 2

    def test_slabs_invariant_to_sharding_and_equal_reference(self,
                                                             tmp_path):
        x, y = _data(200, 4)
        ref = [(s.x, s.y, s.start, s.n_valid) for s in jds.iter_slabs(
            jds.ArraySource(x, y, shard_rows=40), 48)]
        assert ref[-1][3] == 200 - 48 * 4
        for src in _layouts(x, y, tmp_path):
            slabs = [(s.x, s.y, s.start, s.n_valid)
                     for s in ds.iter_slabs(src, 48)]
            assert not slabs[-1][0][slabs[-1][3]:].any()
            for (xa, ya, sa, na), (xb, yb, sb, nb) in zip(ref, slabs,
                                                          strict=True):
                assert xa.tobytes() == xb.tobytes()
                assert ya.tobytes() == yb.tobytes()
                assert (sa, na) == (sb, nb)

    def test_start_row_skips_whole_shards_unread(self):
        x, y = _data(256)
        src = ds.ArraySource(x, y, shard_rows=32)
        slabs = list(ds.iter_slabs(src, 64, start_row=128))
        assert [s.start for s in slabs] == [128, 192]
        assert src.reads[:4] == [0, 0, 0, 0]
        np.testing.assert_array_equal(slabs[0].x, x[128:192])
        # a start row inside a shard reads that shard from its offset
        src = ds.ArraySource(x, y, shard_rows=48)
        slabs = list(ds.iter_slabs(src, 64, start_row=64))
        assert src.reads[0] == 0 and src.reads[1] == 1
        np.testing.assert_array_equal(slabs[0].x, x[64:128])
        with pytest.raises(ValueError, match="multiple"):
            next(iter(ds.iter_slabs(src, 64, start_row=10)))

    def test_slab_arrays_do_not_alias_the_carry_buffer(self):
        # torch.from_numpy zero-copies: if the loader reused its carry
        # buffer across yields, tensors kept from earlier slabs would
        # change under the consumer
        x, y = _data(128)
        src = ds.ArraySource(x, y, shard_rows=32)
        kept = [torch.from_numpy(s.x) for s in ds.iter_slabs(src, 32)]
        for i, xs in enumerate(kept):
            np.testing.assert_array_equal(xs.numpy(),
                                          x[32 * i:32 * (i + 1)])

    def test_labels_checked_shard_by_shard(self):
        x, y = _data(64)
        y[40] = 0.5
        src = ds.ArraySource(x, y, shard_rows=32)
        seen = []
        with pytest.raises(ValueError, match="shard 1: labels"):
            for s in ds.iter_slabs(src, 16):
                seen.append(s.start)
        assert seen == [0, 16]          # shard 0's slabs went through

    def test_accountant_peak_bounded_and_equal_reference(self):
        x, y = _data(512, 8)
        peaks = []
        for mod in (ds, jds):
            src = mod.ArraySource(x, y, shard_rows=32)
            acct = mod.ByteAccountant()
            for _ in mod.iter_slabs(src, 64, depth=2,
                                    executor=mod.SerialExecutor(),
                                    accountant=acct):
                pass
            assert 0 < acct.peak < src.total_bytes
            assert acct.current == 0
            peaks.append(acct.peak)
        assert peaks[0] == peaks[1]
        with pytest.raises(RuntimeError, match="released more"):
            acct.release(1)

    def test_prefetch_kill_and_delay_fire_as_the_reference(self):
        x, y = _data(96)
        fired = []
        for mod, fmod in ((ds, None), (jds, jfaults)):
            plan_cls = FaultPlan if fmod is None else fmod.FaultPlan
            plan = plan_cls(sleeper=None).delay_shard_read(1, 0.25) \
                .kill("data.prefetch", shard=2)
            src = mod.ArraySource(x, y, shard_rows=32)
            seen = []
            with pytest.raises(RuntimeError) as ei:
                for i, *_ in mod.PrefetchLoader(
                        src, depth=1, faults=plan,
                        executor=mod.SerialExecutor()):
                    seen.append(i)
            assert type(ei.value).__name__ == "Preemption"
            assert ei.value.info == {"shard": 2}
            assert seen == [0, 1]
            fired.append(plan.fired)
        assert fired[0] == fired[1]
        assert ("delay", "data.prefetch", {"shard": 1}) in fired[0]

    @pytest.mark.parametrize("depth", [1, 2])
    def test_prefetch_depth_never_above_its_bound(self, depth):
        x, y = _data(320)
        src = ds.ArraySource(x, y, shard_rows=32)
        mets = MetricsRegistry()
        slabs = list(ds.iter_slabs(src, 48, depth=depth, metrics=mets))
        assert len(slabs) == 7 and src.reads == [1] * 10
        snap = mets.snapshot()
        assert 1 <= snap["data.prefetch.depth.max"] <= depth <= 2
        assert snap["data.rows.count"] == 320
        with pytest.raises(ValueError, match="depth"):
            ds.PrefetchLoader(src, depth=0)

    def test_metrics_equal_the_reference(self):
        x, y = _data(160)
        snaps = []
        for mod, reg in ((ds, MetricsRegistry), (jds, JMetrics)):
            mets = reg()
            list(mod.iter_slabs(mod.ArraySource(x, y, shard_rows=32), 64,
                                depth=2, metrics=mets,
                                executor=mod.SerialExecutor()))
            snap = mets.snapshot()
            snaps.append({k: snap[k] for k in (
                "data.rows.count", "data.shard.read_s.count",
                "data.prefetch.depth.max", "data.prefetch.depth.min")})
        assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# one-pass partitioning (Eqn. 7 / Eqn. 8)
# ---------------------------------------------------------------------------

class TestStreamingPlan:
    SPEC = kf.KernelSpec(name="rbf", gamma=0.5)
    JSPEC = jkf.KernelSpec(name="rbf", gamma=0.5)

    def test_reservoir_equals_reference(self):
        x, y = _data(2048, 3, seed=5)
        src = ds.ArraySource(x, y, shard_rows=256)
        jsrc = jds.ArraySource(x, y, shard_rows=256)
        for k, seed in ((64, 9), (64, 10), (500, 0)):
            got = ds.reservoir_sample(src, k, seed=seed)
            assert got.tobytes() == jds.reservoir_sample(
                jsrc, k, seed=seed).tobytes()
        assert not np.array_equal(ds.reservoir_sample(src, 64, seed=9),
                                  ds.reservoir_sample(src, 64, seed=10))
        matches = (x[None] == got[:, None]).all(-1).any(1)
        assert matches.all()
        np.testing.assert_array_equal(ds.reservoir_sample(src, 4096), x)
        with pytest.raises(ValueError, match="positive"):
            ds.reservoir_sample(src, 0)

    def test_sketch_landmarks_exact_when_reservoir_covers(self, tmp_path):
        x, y = _data(160, 5)
        dense = torch.from_numpy(x)[partition.select_landmarks(
            self.SPEC, torch.from_numpy(x), 8)]
        want = np.asarray(jds.sketch_landmarks(
            self.JSPEC, jds.ArraySource(x, y, shard_rows=48), 8,
            reservoir=160))
        for src in _layouts(x, y, tmp_path):
            z = ds.sketch_landmarks(self.SPEC, src, 8, reservoir=160,
                                    device="cpu")
            assert torch.equal(z, dense)
            np.testing.assert_array_equal(z.numpy(), want)
        with pytest.raises(ValueError, match="reservoir"):
            ds.sketch_landmarks(self.SPEC, src, 8, reservoir=4,
                                device="cpu")

    def test_strata_match_dense_and_reference(self):
        x, y = _data(256, 5)
        xt = torch.from_numpy(x)
        idx = partition.select_landmarks(self.SPEC, xt, 6)
        dense = partition.assign_strata(self.SPEC, xt, idx)
        got, _ = ds.StreamingAssigner(self.SPEC, xt[idx], 4).assign(x)
        np.testing.assert_array_equal(got, dense.numpy())
        want = np.asarray(jds.assign_strata_values(
            self.JSPEC, jnp.asarray(x), jnp.asarray(xt[idx].numpy())))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int32

    def test_assignment_layout_invariant_and_equal_reference(self,
                                                            tmp_path):
        x, y = _data(300, 5)
        plan = ds.streaming_plan(self.SPEC, ds.ArraySource(x, y, 64),
                                 n_partitions=4, n_landmarks=6,
                                 reservoir=300, device="cpu")
        jplan = jds.streaming_plan(self.JSPEC, jds.ArraySource(x, y, 64),
                                   n_partitions=4, n_landmarks=6,
                                   reservoir=300)
        np.testing.assert_array_equal(plan.landmarks.numpy(),
                                      np.asarray(jplan.landmarks))
        ref_s, ref_p = plan.assigner.assign(x)
        js, jp = jplan.assigner.assign(x)
        np.testing.assert_array_equal(ref_s, js)
        np.testing.assert_array_equal(ref_p, jp)
        for src in _layouts(x, y, tmp_path):
            assigner = ds.StreamingAssigner(self.SPEC, plan.landmarks, 4)
            ss, ps = [], []
            for _, xs, _ in ds.PrefetchLoader(src):
                s, p = assigner.assign(xs)
                ss.append(s)
                ps.append(p)
            np.testing.assert_array_equal(np.concatenate(ss), ref_s)
            np.testing.assert_array_equal(np.concatenate(ps), ref_p)
        for s in np.unique(ref_s):
            counts = np.bincount(ref_p[ref_s == s], minlength=4)
            assert counts.max() - counts.min() <= 1
        with pytest.raises(ValueError, match="n_partitions"):
            ds.StreamingAssigner(self.SPEC, plan.landmarks, 0)


# ---------------------------------------------------------------------------
# streamed fits
# ---------------------------------------------------------------------------

def _linear_problem():
    return ProblemSpec(kernel=kf.KernelSpec(name="linear"),
                       params=odm.ODMParams(lam=10.0))


def _dsvrg_cfg(**kw):
    kw.setdefault("epochs", 4)
    kw.setdefault("batch", 64)
    kw.setdefault("schedule", "serial")
    kw.setdefault("stream_slab", 128)
    # the route hands a stratified or random outer strategy down to
    # DSVRGConfig, so an identity chain is asked for at both levels
    outer = "identity" if kw.get("partition_strategy") == "identity" \
        else "stratified"
    return sodm.SODMConfig(engine="dsvrg", partition_strategy=outer,
                           dsvrg=DSVRGConfig(**kw))


def _fit(problem, route, cfg, src, **kw):
    return ODMEstimator(problem, route=route, cfg=cfg,
                        device="cpu").fit(src, **kw)


def _reference_stream(x, y, cfg, shard_rows=128):
    jcfg = jd.DSVRGConfig(**{f: getattr(cfg.dsvrg, f)
                             for f in ("epochs", "batch", "schedule",
                                       "stream_slab", "eta")})
    res, kkt = jd._solve_stream(jds.ArraySource(x, y, shard_rows),
                                jodm.ODMParams(lam=10.0), jcfg, KEY)
    return res, float(kkt)


class TestDsvrgStreaming:
    def test_bitwise_invariant_to_sharding(self, tmp_path):
        x, y = _data(512, 8, seed=1)
        problem, cfg = _linear_problem(), _dsvrg_cfg()
        outs = []
        for src in _layouts(x, y, tmp_path):
            m, rep = _fit(problem, "dsvrg", cfg, src)
            outs.append((m.w, rep.history, rep.kkt, rep.eta))
        w0, h0, k0, e0 = outs[0]
        for w, h, k, e in outs[1:]:
            assert torch.equal(w, w0)
            assert (h, k, e) == (h0, k0, e0)

    def test_matches_reference_stream(self):
        x, y = _data(512, 8, seed=1)
        cfg = _dsvrg_cfg()
        m, rep = _fit(_linear_problem(), "dsvrg", cfg,
                      ds.ArraySource(x, y, shard_rows=128))
        want, kkt = _reference_stream(x, y, cfg)
        gap = _rel(m.w.numpy(), want.w)
        print(f"streamed dsvrg, port vs reference: max|dw|/||w|| = "
              f"{gap:.3e}")
        assert gap <= 1e-2
        np.testing.assert_allclose(rep.eta, float(want.eta), rtol=1e-5)
        np.testing.assert_allclose(rep.history, np.asarray(want.history),
                                   rtol=1e-3)
        np.testing.assert_allclose(rep.kkt, kkt, rtol=1e-2, atol=1e-5)
        xt = _data(256, 8, seed=9)[0]
        agree = np.mean(np.sign(xt @ m.w.numpy())
                        == np.sign(xt @ np.asarray(want.w)))
        assert agree >= 0.99
        assert rep.raw.perm is None and len(rep.history) == 4

    def test_matches_resident_identity_solve(self):
        x, y = _data(512, 8, seed=1)
        problem = _linear_problem()
        cfg = _dsvrg_cfg(n_partitions=1, partition_strategy="identity")
        m_s, rep_s = _fit(problem, "dsvrg", cfg,
                          ds.ArraySource(x, y, shard_rows=128))
        m_m, rep_m = ODMEstimator(problem, route="dsvrg", cfg=cfg,
                                  device="cpu").fit(x, y, 0)
        gap = _rel(m_s.w.numpy(), m_m.w.numpy())
        print(f"streamed vs resident identity dsvrg: {gap:.3e}")
        assert gap <= 1e-2
        np.testing.assert_allclose(rep_s.eta, rep_m.eta, rtol=1e-5)
        np.testing.assert_allclose(rep_s.history, rep_m.history, rtol=1e-3)
        xt = torch.from_numpy(_data(128, 8, seed=9)[0])
        assert bool(torch.equal(m_s.predict(xt), m_m.predict(xt)))

    @pytest.mark.parametrize("fused", [None, False])
    def test_padded_minibatches_match_the_masked_chain(self, fused):
        """M = 300 in slabs of 128 with b = 32: the last slab holds 44
        rows, two live minibatches and two fully padded ones. The port
        launches only the live ones; the reference masks the empty ones
        to a no-op. Both must agree, and differ from the chain that
        steps on the empty minibatches."""
        x, y = _data(300, 8, seed=4)
        cfg = _dsvrg_cfg(epochs=1, batch=32, fused=fused)
        m, rep = _fit(_linear_problem(), "dsvrg", cfg,
                      ds.ArraySource(x, y, shard_rows=70))
        want, _ = _reference_stream(x, y, cfg, shard_rows=70)
        gap = _rel(m.w.numpy(), want.w)
        print(f"padded last slab, port vs reference: {gap:.3e}")
        assert gap <= 1e-5
        # the unmasked chain: the same epoch, but every slab's C = 4
        # minibatches walked, the empty ones stepping by w - anchor + h
        params = odm.ODMParams(lam=10.0)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        anchor = torch.zeros(8)
        h = odm.primal_grad(anchor, xt, yt, params)
        eta = torch.tensor(rep.eta)
        w = anchor
        for lo in range(0, 384, 128):
            xs = torch.zeros(128, 8)
            ys = torch.zeros(128)
            n = min(128, 300 - lo)
            xs[:n], ys[:n] = xt[lo:lo + n], yt[lo:lo + n]
            wts = (torch.arange(128) < n).float().reshape(4, 32)
            inv_n = (1.0 / torch.clamp_min(wts.sum(-1), 1.0))[:, None]
            w = og.odm_svrg_epoch_plain(
                w, anchor, h, xs.reshape(1, 4, 32, 8),
                ys.reshape(1, 4, 32), wts, inv_n, eta,
                **td._hinge_kw(params))
        unmasked = _rel(w.numpy(), want.w)
        print(f"padded last slab, unmasked chain vs reference: "
              f"{unmasked:.3e}")
        assert unmasked > 1e-3

    def test_e2e_fit_under_a_quarter_of_the_data_bytes(self):
        rows, d = 16384, 8
        src = ds.SyntheticSource(rows, d, shard_rows=1024, seed=2, sep=1.5)
        budget = src.total_bytes // 4
        cfg = _dsvrg_cfg(epochs=2, batch=256, stream_slab=1024,
                         n_partitions=1, partition_strategy="identity")
        acct = ds.ByteAccountant()
        m_s, rep = _fit(_linear_problem(), "dsvrg", cfg, src,
                        accountant=acct)
        assert 0 < acct.peak < budget < src.total_bytes
        x, y = ds.materialize(src)
        m_m, _ = ODMEstimator(_linear_problem(), route="dsvrg", cfg=cfg,
                              device="cpu").fit(x, y, 0)
        assert _rel(m_s.w.numpy(), m_m.w.numpy()) <= 1e-2
        xt = torch.from_numpy(x)
        assert float((m_s.predict(xt) == m_m.predict(xt)).float()
                     .mean()) >= 0.99
        assert rep.passes[0] == 2 and rep.n_train == rows

    def test_zero_epochs_returns_the_start_as_the_reference(self):
        x, y = _data(96, 4)
        cfg = _dsvrg_cfg(epochs=0)
        res, kkt = td._solve_stream(ds.ArraySource(x, y, 32), odm.ODMParams(
            lam=10.0), cfg.dsvrg, device="cpu")
        want, jkkt = _reference_stream(x, y, cfg, shard_rows=32)
        assert torch.equal(res.w, torch.zeros(4))
        np.testing.assert_array_equal(res.w.numpy(), np.asarray(want.w))
        assert res.history.shape == (0,) == np.asarray(want.history).shape
        assert float(res.eta) == float(want.eta) == 0.0
        assert float(kkt) == jkkt == 0.0

    def test_streaming_capability_declared(self):
        assert treg.streaming_routes() == ["dsvrg", "cascade"]
        assert "streaming=True" in treg.get("dsvrg").capabilities()
        assert "streaming=True" in treg.get("cascade").capabilities()


class TestCascadeStreaming:
    PROBLEM = ProblemSpec(kernel=kf.KernelSpec(name="rbf", gamma=0.5),
                          params=odm.ODMParams(lam=50.0))
    CFG = sodm.SODMConfig(levels=3, tol=1e-6, max_sweeps=200)

    def test_bitwise_invariant_to_sharding(self, tmp_path):
        x, y = _data(192, 6)            # 4 leaves of 48 rows
        xt = torch.from_numpy(_data(64, 6, seed=7)[0])
        cfg = sodm.SODMConfig(levels=2, tol=1e-6, max_sweeps=200)
        ref = None
        for src in _layouts(x, y, tmp_path):
            m, rep = _fit(self.PROBLEM, "cascade", cfg, src)
            scores = m.decision_function(xt)
            assert rep.passes == (cfg.levels + 1,)
            if ref is None:
                ref = scores
            else:
                assert torch.equal(scores, ref)

    def test_matches_reference_stream(self):
        x, y = _data(256, 6)
        xt = _data(64, 6, seed=7)[0]
        m, _ = _fit(self.PROBLEM, "cascade", self.CFG,
                    ds.ArraySource(x, y, shard_rows=64))
        jspec = jkf.KernelSpec(name="rbf", gamma=0.5)
        want = jb._cascade_solve_stream(
            jspec, jds.ArraySource(x, y, shard_rows=64),
            jodm.ODMParams(lam=50.0), levels=3, tol=1e-6, max_sweeps=200)
        f_ref = np.asarray(jmodel.from_cascade(jspec, want)
                           .decision_function(jnp.asarray(xt)))
        gap = float(np.abs(m.decision_function(torch.from_numpy(xt))
                           .numpy() - f_ref).max())
        print(f"streamed cascade, port vs reference: max|df| = {gap:.3e}")
        assert gap <= 1e-5

    def test_matches_dense_identity_cascade(self):
        x, y = _data(256, 6)
        dense = tb._cascade_solve(
            self.PROBLEM.kernel, torch.from_numpy(x), torch.from_numpy(y),
            self.PROBLEM.params, levels=3, tol=1e-6, max_sweeps=200,
            perm=torch.arange(256))
        m_s, _ = _fit(self.PROBLEM, "cascade", self.CFG,
                      ds.ArraySource(x, y, shard_rows=64))
        xt = torch.from_numpy(_data(64, 6, seed=7)[0])
        f_dense = tmodel.from_cascade(self.PROBLEM.kernel,
                                      dense).decision_function(xt)
        assert float(torch.max(torch.abs(m_s.decision_function(xt)
                                         - f_dense))) <= 1e-5


# ---------------------------------------------------------------------------
# dispatch stays loud
# ---------------------------------------------------------------------------

class TestDispatch:
    def test_source_plus_y_rejected(self):
        x, y = _data(64)
        src = ds.ArraySource(x, y, shard_rows=32)
        with pytest.raises(ValueError, match="ambiguous"):
            ODMEstimator(_linear_problem(), device="cpu").fit(src, y)

    def test_non_streaming_route_rejected(self):
        x, y = _data(64)
        src = ds.ArraySource(x, y, shard_rows=32)
        for route in ("sodm", "dip", "dc", "svrg", "csvrg"):
            kernel = "linear" if route in ("svrg", "csvrg") else "rbf"
            with pytest.raises(ValueError, match="Streaming routes"):
                ODMEstimator(ProblemSpec.create(kernel), route=route,
                             device="cpu").fit(src)

    def test_entry_points_default_to_the_card(self, monkeypatch):
        # no silent host fallback: with no card, the plan's entry points
        # raise naming device="cpu", and the drivers take no default
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        x, y = _data(64)
        src = ds.ArraySource(x, y, shard_rows=32)
        spec = kf.KernelSpec(name="linear")
        for call in (lambda: ds.sketch_landmarks(spec, src, 4),
                     lambda: ds.streaming_plan(spec, src, 2, 4)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        with pytest.raises(TypeError, match="device"):
            td._solve_stream(src, odm.ODMParams(), DSVRGConfig())
        with pytest.raises(TypeError, match="device"):
            tb._cascade_solve_stream(spec, src, odm.ODMParams(), levels=1)

    def test_auto_policy_linear_dsvrg_kernel_cascade(self):
        lin = ProblemSpec(kernel=kf.KernelSpec(name="linear"))
        rbf = ProblemSpec(kernel=kf.KernelSpec(name="rbf", gamma=1.0))
        assert treg.resolve(lin, M=1024, streaming=True).name == "dsvrg"
        assert treg.resolve(rbf, M=1024, streaming=True).name == "cascade"

    def test_loader_knobs_rejected_on_dense_fit(self):
        x, y = _data(64)
        for kw in ({"accountant": ds.ByteAccountant()}, {"depth": 3},
                   {"executor": ds.SerialExecutor()},
                   {"metrics": MetricsRegistry()}):
            with pytest.raises(ValueError, match="loader"):
                ODMEstimator(_linear_problem(), route="dsvrg",
                             device="cpu").fit(x, y, 0, **kw)

    def test_parallel_schedule_and_ragged_cascade_rejected(self):
        x, y = _data(96)
        src = ds.ArraySource(x, y, shard_rows=32)
        with pytest.raises(ValueError, match="serial"):
            _fit(_linear_problem(), "dsvrg", _dsvrg_cfg(schedule="parallel"),
                 src)
        with pytest.raises(ValueError, match="must divide"):
            _fit(ProblemSpec(), "cascade", sodm.SODMConfig(levels=6), src)


# ---------------------------------------------------------------------------
# chaos: mid-stream kills resume without rework
# ---------------------------------------------------------------------------

@pytest.mark.chaos
class TestStreamingChaos:
    PROBLEM = ProblemSpec(kernel=kf.KernelSpec(name="rbf", gamma=0.5),
                          params=odm.ODMParams(lam=50.0))
    CFG = sodm.SODMConfig(levels=3, tol=1e-6, max_sweeps=200)

    def test_cascade_mid_stream_kill_resumes_without_rereads(
            self, tmp_path):
        x, y = _data(256, 6)
        m_ok, _ = _fit(self.PROBLEM, "cascade", self.CFG,
                       ds.NpyShardSource.write(str(tmp_path / "a"), x, y,
                                               32))
        src = ds.NpyShardSource.write(str(tmp_path / "b"), x, y, 32)
        est = ODMEstimator(self.PROBLEM, route="cascade", cfg=self.CFG,
                           device="cpu")
        rdir = str(tmp_path / "resume")
        with pytest.raises(Preemption):
            est.fit(src, resume=rdir, faults=FaultPlan().kill_at_shard(5))
        assert src.reads[:5] == [1] * 5          # leaves 0-4 completed
        m2, _ = est.fit(src, resume=rdir)
        assert src.reads[:5] == [1] * 5          # and not read again
        xt = torch.from_numpy(_data(64, 6, seed=7)[0])
        assert torch.equal(m2.decision_function(xt),
                           m_ok.decision_function(xt))

    def test_cascade_stream_checkpoints_match_the_reference_layout(
            self, tmp_path):
        x, y = _data(64, 4)
        dp, dj = str(tmp_path / "port"), str(tmp_path / "ref")
        cfg = sodm.SODMConfig(levels=2, tol=1e-6, max_sweeps=50)
        ODMEstimator(self.PROBLEM, route="cascade", cfg=cfg,
                     device="cpu").fit(ds.ArraySource(x, y, 16), resume=dp)
        JEstimator(JProblem(kernel=jkf.KernelSpec("rbf", 0.5),
                            params=jodm.ODMParams(lam=50.0)),
                   route="cascade",
                   cfg=jsodm.SODMConfig(levels=2, tol=1e-6,
                                        max_sweeps=50)).fit(
            jds.ArraySource(x, y, 16), key=KEY, resume=dj)
        assert sorted(os.listdir(dp)) == sorted(os.listdir(dj))
        for step in sorted(os.listdir(dp)):
            mp, mj = (json.load(open(os.path.join(r, step,
                                                  "manifest.json")))
                      for r in (dp, dj))
            assert {k: v["shape"] for k, v in mp["leaves"].items()} == \
                {k: v["shape"] for k, v in mj["leaves"].items()}
            a, b = mp["metadata"], mj["metadata"]
            for k in ("route", "mode", "leaf", "tiers"):
                assert a[k] == b[k], k
            assert a["provenance"]["data"] == b["provenance"]["data"]

    def test_dsvrg_stream_kill_at_epoch_resumes_bitwise(self, tmp_path):
        x, y = _data(512, 8, seed=1)
        problem, cfg = _linear_problem(), _dsvrg_cfg()
        m_ok, rep_ok = _fit(problem, "dsvrg", cfg, ds.NpyShardSource.write(
            str(tmp_path / "a"), x, y, 96))
        src = ds.NpyShardSource.write(str(tmp_path / "b"), x, y, 96)
        est = ODMEstimator(problem, route="dsvrg", cfg=cfg, device="cpu")
        rdir = str(tmp_path / "resume")
        with pytest.raises(Preemption):
            est.fit(src, resume=rdir, faults=FaultPlan().kill_at_epoch(2))
        m2, rep2 = est.fit(src, resume=rdir)
        assert torch.equal(m2.w, m_ok.w)
        assert rep2.history == rep_ok.history

    def test_dsvrg_prefetch_kill_mid_epoch_resumes_bitwise(self, tmp_path):
        """Killed at epoch 2, then killed again by a shard read in the
        middle of the resumed epoch 2, then resumed to the end."""
        x, y = _data(512, 8, seed=1)
        problem, cfg = _linear_problem(), _dsvrg_cfg()
        m_ok, rep_ok = _fit(problem, "dsvrg", cfg,
                            ds.ArraySource(x, y, shard_rows=96))
        src = ds.ArraySource(x, y, shard_rows=96)
        est = ODMEstimator(problem, route="dsvrg", cfg=cfg, device="cpu")
        rdir = str(tmp_path / "resume")
        with pytest.raises(Preemption):
            est.fit(src, resume=rdir, faults=FaultPlan().kill_at_epoch(2))
        plan = FaultPlan().kill("data.prefetch", shard=3)
        with pytest.raises(Preemption) as ei:
            est.fit(src, resume=rdir, faults=plan,
                    executor=ds.SerialExecutor())
        assert ei.value.info == {"shard": 3}
        m2, rep2 = est.fit(src, resume=rdir)
        assert torch.equal(m2.w, m_ok.w)
        assert rep2.history == rep_ok.history

    def test_stream_and_dense_checkpoints_do_not_splice(self, tmp_path):
        x, y = _data(256, 6)
        src = ds.ArraySource(x, y, shard_rows=32)
        rdir = str(tmp_path / "resume")
        _fit(self.PROBLEM, "cascade", self.CFG, src, resume=rdir)
        prov = resume_mod.provenance_source(self.PROBLEM.kernel,
                                            self.PROBLEM.params, self.CFG,
                                            src, 0)
        mgr = resume_mod.CascadeResumeManager(
            resume_mod.ResumeConfig(rdir), prov)
        with pytest.raises(resume_mod.ProvenanceError, match="stream"):
            mgr.restore()
        assert mgr.restore_stream().leaf == 8
        # and a dense cascade directory does not feed a stream
        ddir = str(tmp_path / "dense")
        mgr_d = resume_mod.CascadeResumeManager(
            resume_mod.ResumeConfig(ddir), prov)
        mgr_d.save_level(level=3, K=8, m=32, alphas=torch.zeros(8, 64),
                         perm=torch.arange(256), sweeps_per_level=[1],
                         kkt=0.0)
        with pytest.raises(resume_mod.ProvenanceError, match="level"):
            mgr_d.restore_stream()

    def test_foreign_source_provenance_rejected(self, tmp_path):
        x, y = _data(256, 6)
        est = ODMEstimator(self.PROBLEM, route="cascade", cfg=self.CFG,
                           device="cpu")
        rdir = str(tmp_path / "resume")
        est.fit(ds.ArraySource(x, y, shard_rows=32), resume=rdir)
        x2, y2 = _data(256, 6, seed=42)
        with pytest.raises(resume_mod.ProvenanceError, match="different"):
            est.fit(ds.ArraySource(x2, y2, shard_rows=32), resume=rdir)
