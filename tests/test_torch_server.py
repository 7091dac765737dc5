"""repro_torch.serve.server against repro.serve.server on the same numpy
inputs: the bucket ladder, bucketed scores, the bounded set of prepared
buckets, the deadline batcher's flush decisions on a virtual clock (with
and without a ``serve.flush`` delay), ``serve_stream``'s exact
nearest-rank percentiles, and the spans and metrics of a traced replay.

On the CPU the port's scorer runs the eager plain path on the same
ladder; its CUDA graphs are held to the eager kernel in
tests/test_torch_cuda.py and chip_smoke.py phase 4b."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import observe as jobserve
from repro.core import kernel_fns as jkf
from repro.distributed.faults import FaultPlan as JFaultPlan
from repro.serve import model as jmodel
from repro.serve import server as jserver
from repro_torch import interop, observe
from repro_torch.distributed.faults import FaultPlan
from repro_torch.serve import server

SPECS = [dict(name="rbf", gamma=0.5), dict(name="laplacian", gamma=0.3),
         dict(name="poly", gamma=0.5, degree=2, coef0=1.0),
         dict(name="linear")]


def _models(spec: dict, S=96, d=6, seed=0):
    """The same model in both packages: an SV slab and coefficients drawn
    with numpy (the linear kernel as its collapsed w)."""
    rng = np.random.default_rng(seed)
    x_sv = rng.standard_normal((S, d)).astype(np.float32)
    coef = rng.standard_normal(S).astype(np.float32)
    jspec = jkf.KernelSpec(**spec)
    if spec["name"] == "linear":
        w = (x_sv.T @ coef).astype(np.float32)
        jm = jmodel.FittedODM(spec=jspec, w=jnp.asarray(w),
                              compression="linear")
        tm = interop.fitted_from_numpy(spec, w=w, compression="linear",
                                       device="cpu")
    else:
        jm = jmodel.FittedODM(spec=jspec, x_sv=jnp.asarray(x_sv),
                              coef=jnp.asarray(coef))
        tm = interop.fitted_from_numpy(spec, x_sv=x_sv, coef=coef,
                                       device="cpu")
    xq = rng.standard_normal((160, d)).astype(np.float32)
    return jm, tm, xq


def _rel_gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale


def test_bucket_ladder_equals_reference():
    for mb in range(1, 301):
        assert server._bucket_ladder(mb) == jserver._bucket_ladder(mb), mb


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["name"])
def test_bucketed_scores_match_decision_function(spec):
    jm, tm, xq = _models(spec)
    scorer = server.MicrobatchScorer(tm, max_batch=32)
    jscorer = jserver.MicrobatchScorer(jm, max_batch=32)
    for B in (1, 3, 7, 17, 32, 77, 128):     # 77/128 exercise chunking
        got = scorer.score(torch.from_numpy(xq[:B]))
        assert got.shape == (B,)
        assert _rel_gap(got, tm.decision_function(xq[:B])) < 1e-6, B
        assert _rel_gap(got, jscorer.score(jnp.asarray(xq[:B]))) < 1e-5, B
    assert torch.equal(scorer.predict(xq[:5]), torch.sign(scorer.score(
        xq[:5])))


def test_compiles_bounded_by_bucket_ladder_as_the_reference():
    jm, tm, xq = _models(SPECS[0])
    scorer = server.MicrobatchScorer(tm, max_batch=32)
    jscorer = jserver.MicrobatchScorer(jm, max_batch=32)
    for B in (1, 2, 5, 5, 9, 33):
        scorer.score(xq[:B])
        jscorer.score(jnp.asarray(xq[:B]))
        assert scorer.compiles == jscorer.compiles
    for B in range(1, 33):
        scorer.score(xq[:B])
    assert scorer.compiles <= len(scorer.buckets)
    assert scorer.buckets == jscorer.buckets == (1, 2, 4, 8, 16, 32)
    assert scorer.calls == 6 + 32
    assert scorer.graphs == {} and scorer.replays == {}   # CPU: eager


def test_empty_batch():
    _, tm, xq = _models(SPECS[0])
    scorer = server.MicrobatchScorer(tm, max_batch=32)
    out = scorer.score(torch.from_numpy(xq[:0]))
    assert out.shape == (0,) and scorer.compiles == 0


def _trace(n=96, seed=1):
    """Arrival times with bursts and gaps around the deadline."""
    rng = np.random.default_rng(seed)
    gaps = rng.choice([5e-6, 1e-4, 6e-4, 2.5e-3], size=n,
                      p=[0.5, 0.25, 0.15, 0.1])
    return [float(t) for t in np.cumsum(gaps)]


def _replay(jm, tm, xq, times, faults):
    """The same trace through both batchers; faults: (port plan,
    reference plan) or None."""
    out = []
    for pkg, m in (("port", tm), ("ref", jm)):
        if pkg == "port":
            b = server.Batcher(server.MicrobatchScorer(m, max_batch=32),
                               max_batch=8, max_wait=1e-3,
                               faults=faults and faults[0])
            rows = [torch.from_numpy(xq[i % len(xq)]) for i in
                    range(len(times))]
            stats = server.serve_stream(b, zip(times, rows))
        else:
            b = jserver.Batcher(jserver.MicrobatchScorer(m, max_batch=32),
                                max_batch=8, max_wait=1e-3,
                                faults=faults and faults[1])
            rows = [jnp.asarray(xq[i % len(xq)]) for i in
                    range(len(times))]
            stats = jserver.serve_stream(b, zip(times, rows))
        out.append(stats)
    return out


@pytest.mark.parametrize("delay", [None, 3e-3], ids=["plain", "delayed"])
def test_flush_decisions_equal_reference(delay):
    jm, tm, xq = _models(SPECS[0])
    times = _trace()
    faults = None
    if delay is not None:
        faults = tuple(P(sleeper=None).delay("serve.flush", delay, batch=8,
                                             count=2)
                       for P in (FaultPlan, JFaultPlan))
    port, ref = _replay(jm, tm, xq, times, faults)
    assert port["batches"] == ref["batches"]
    assert 1 < port["mean_batch"] == ref["mean_batch"]
    # the rids of each flush, in order, and their completion times
    assert [(r.rid, r.t_arrival, r.t_done) for r in port["results"]] == \
        [(r.rid, r.t_arrival, r.t_done) for r in ref["results"]]
    if delay is not None:
        assert faults[0].fired == faults[1].fired
        assert len(faults[0].fired) == 2
    want = tm.decision_function(xq).numpy()
    for r in port["results"]:
        assert abs(r.score - float(want[r.rid % len(xq)])) <= 1e-5
    got = {r.rid: r.score for r in port["results"]}
    for r in ref["results"]:
        assert abs(got[r.rid] - r.score) <= 1e-5


def test_delay_shifts_exactly_the_delayed_batch():
    jm, tm, xq = _models(SPECS[0])
    times = _trace()
    base, _ = _replay(jm, tm, xq, times, None)
    plan = FaultPlan(sleeper=None).delay("serve.flush", 0.25, batch=8)
    delayed, _ = _replay(jm, tm, xq, times, (plan, JFaultPlan(None)))
    first = delayed["batches"].index(8)
    b0 = sum(delayed["batches"][:first])
    for i, (a, b) in enumerate(zip(base["results"], delayed["results"])):
        assert a.rid == b.rid
        hit = b0 <= i < b0 + 8
        assert b.t_done == (a.t_done + 0.25 if hit else a.t_done)


def test_stream_percentiles_equal_reference():
    jm, tm, xq = _models(SPECS[0])
    port, ref = _replay(jm, tm, xq, _trace(n=200, seed=5), None)
    assert port["latencies"] == ref["latencies"]
    for q in ("p50", "p95", "p99"):
        assert port[q] == ref[q]
    lat = port["latencies"]
    assert port["p50"] == observe.percentile(lat, 50) == \
        jobserve.percentile(lat, 50)
    assert port["p50"] <= port["p95"] <= port["p99"] <= max(lat)


def test_deadline_and_full_batch_flush():
    _, tm, xq = _models(SPECS[0])
    b = server.Batcher(server.MicrobatchScorer(tm, max_batch=32),
                       max_batch=4, max_wait=1e-3)
    for i in range(3):
        b.submit(xq[i], now=0.0)
    assert not b.ready(0.0005)
    assert b.poll(0.0005) == []
    assert [r.rid for r in b.poll(0.0015)] == [0, 1, 2]
    assert b.batches == [3]
    b = server.Batcher(server.MicrobatchScorer(tm, max_batch=32),
                       max_batch=4, max_wait=10.0)
    for i in range(5):
        b.submit(xq[i], now=0.0)
    assert len(b.poll(0.0)) == 4 and len(b._pending) == 1


def test_request_batch_contains_score_span():
    """A traced replay emits nested serve.request_batch -> serve.score
    spans, and the registry sees every request (the reference's
    tests/test_serve.py::test_request_batch_contains_score_span)."""
    _, tm, xq = _models(SPECS[0])
    reg = observe.MetricsRegistry()
    b = server.Batcher(
        server.MicrobatchScorer(tm, max_batch=32, metrics=reg),
        max_batch=8, max_wait=1e-3, metrics=reg)
    rec = observe.SpanRecorder()
    with observe.install(rec):
        server.serve_stream(
            b, ((i * 1e-4, xq[i % xq.shape[0]]) for i in range(24)))
    outer = rec.spans("serve.request_batch")
    inner = rec.spans("serve.score")
    assert outer and len(inner) >= len(outer)
    for s in inner:
        assert any(o["ts"] <= s["ts"] and
                   s["ts"] + s["dur"] <= o["ts"] + o["dur"]
                   for o in outer)
    snap = reg.snapshot()
    assert snap["serve.request.latency_s.count"] == 24
    assert snap["serve.requests.count"] == 24
    assert snap["serve.batches.count"] == len(outer)
    assert snap["serve.score.calls.count"] == len(outer)
    assert snap["serve.queue_depth.max"] >= 1


def test_sharded_scoring_waits_for_multi_device(tmp_path):
    """score_sharded on a one-rank gloo mesh equals decision_function
    (the multi-rank cases: tests/test_torch_spmd.py)."""
    from repro_torch.launch.mesh import make_host_mesh
    from torch_dist_util import gloo_world
    with gloo_world(tmp_path / "store"):
        mesh = make_host_mesh((1,), ("data",))
        for spec in SPECS:
            _, tm, xq = _models(spec)
            got = server.score_sharded(tm, xq[:40], mesh)
            want = tm.decision_function(torch.tensor(xq[:40]))
            assert torch.equal(got, want), spec
