"""Microbatching throughput scorer for compiled ODM models.

Port of ``repro.serve.server``. Two layers, composable:

* :class:`MicrobatchScorer` — pads every request batch up to a fixed
  bucket ladder (powers of two by default), so the work prepared per
  shape is bounded by ``len(buckets)`` however many distinct batch sizes
  traffic produces; batches above the top bucket are chunked. Where the
  reference traces one jit per bucket, the port captures, on a CUDA model
  with a kernel expansion, one ``torch.cuda.CUDAGraph`` per bucket at the
  bucket's first use: a static ``(bucket, d)`` input buffer and the
  scoring call inside the graph (the rows' padding and norms, K2 —
  ``kernels.score``'s scorer — and its split reduction). The SV slab's
  row norms and padded features are made once per model
  (:func:`repro_torch.kernels.score.prepare_slab`) and read by every
  graph: made in each replay they took 5.5 % of it on an H100 (PERF.md
  §6). A call copies each chunk into its bucket's buffer (rows
  past the chunk zeroed, as the reference's pad is), replays the graph
  and clones the slice it returns before the next replay overwrites the
  static output. ``compiles`` counts the buckets prepared (on the card,
  the captured graphs). K2's launches on the serving path are the
  graphs' warm-ups and replays: each bumps ``score_tiles.launches``
  (the process-wide ``launch.score_tiles`` counter), and each graph also
  counts its own replays.
  A CPU model runs the same ladder eagerly through the kernel's plain
  version; the linear-collapse model (``model.w``) scores ``x @ w``
  eagerly on either device (one library matvec, no kernel of the port).
* :class:`Batcher` — a deadline microbatcher: requests queue until
  either ``max_batch`` are waiting or the oldest has waited ``max_wait``
  seconds, then the whole batch is scored in one scorer call. Time is
  injected (``now`` arguments) so tests and replay drivers are
  deterministic; :func:`serve_stream` replays an (arrival_time, x) trace
  through it and reports latency/throughput stats.

A graph's capture failing raises; nothing gives way to an eager call.

:func:`score_sharded` slabs the support vectors over the ``data`` axis of
a ``torch.distributed`` device mesh: every rank scores the replicated
request batch with K2 against its own slice of the slab and one ``psum``
assembles f.
"""
from __future__ import annotations

import dataclasses
import time
import weakref

import torch

from repro_torch import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels import score as score_mod
from repro_torch.observe.instruments import MetricsRegistry, percentile
from repro_torch.observe.spans import span as _span
from repro_torch.serve.model import FittedODM

Tensor = torch.Tensor


def _bucket_ladder(max_batch: int) -> tuple[int, ...]:
    """1, 2, 4, ... up to (and including) max_batch."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def capture_graph(run) -> tuple[torch.cuda.CUDAGraph, object]:
    """One call of ``run`` captured into a CUDA graph, after one launched
    call of it on a side stream, as PyTorch's graph recipe does: the
    library load, the kernel's cached plan and its shared-memory
    attribute are all made there, outside the capture.
    Returns ``(graph, run's output)``; the output's storage lives in the
    graph's private pool and every replay rewrites it. A failed capture
    raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    return graph, out


class _BucketGraph:
    """One bucket's captured scoring call: the static input ``x``
    (bucket, d), the static output ``out`` (bucket,), the graph, and the
    count of its replays. Its warm-up and each replay launch K2 once and
    bump ``score_tiles.launches``."""

    def __init__(self, bucket: int, z: Tensor, coef: Tensor, spec,
                 slab: tuple):
        self.x = torch.zeros(bucket, z.shape[1], dtype=torch.float32,
                             device=z.device)

        def run():
            return score_mod.launch_score(
                self.x, z, coef, kind=spec.name, gamma=spec.gamma,
                degree=spec.degree, coef0=spec.coef0, slab=slab)

        with torch.cuda.device(z.device):
            self.graph, self.out = capture_graph(run)
        score_mod.score_tiles.launches.bump()
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        score_mod.score_tiles.launches.bump()
        self.replays += 1


class MicrobatchScorer:
    """Bucket-padded scoring with a bounded set of prepared shapes (see
    the module docs): on a CUDA model with SVs one captured graph per
    bucket, else the eager path on the same ladder."""

    def __init__(self, model: FittedODM, max_batch: int = 256,
                 buckets: tuple[int, ...] | None = None,
                 metrics: MetricsRegistry | None = None):
        self.model = model
        self.metrics = metrics
        self.buckets = tuple(sorted(buckets or _bucket_ladder(max_batch)))
        self.max_batch = self.buckets[-1]
        self.calls = 0
        self.graphs: dict[int, _BucketGraph] = {}
        self._seen: set[int] = set()
        self._graphed = model.w is None and model.device.type == "cuda"
        if self._graphed:
            # the graphs read these by address: hold them for their life
            self._z = model.x_sv.contiguous()
            self._coef = model.coef.to(torch.float32).contiguous()
            self._slab = score_mod.prepare_slab(self._z, model.spec.name)

    @property
    def compiles(self) -> int:
        """Distinct buckets prepared so far (on the card, the captured
        graphs); <= len(buckets) always."""
        return len(self._seen)

    @property
    def replays(self) -> dict[int, int]:
        """Replays per captured bucket (each also bumps
        ``score_tiles.launches``)."""
        return {b: g.replays for b, g in sorted(self.graphs.items())}

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def _score_chunk(self, xc: Tensor, bucket: int) -> Tensor:
        n = xc.shape[0]
        if not self._graphed:
            xb = xc.to(self.model.device)
            if n < bucket:
                xb = torch.nn.functional.pad(xb, (0, 0, 0, bucket - n))
            if self.model.w is not None:
                out = xb @ self.model.w
            else:
                m = self.model
                out = ops.decision_scores(xb, m.x_sv, m.coef, m.spec)
            return out[:n]
        bg = self.graphs.get(bucket)
        if bg is None:
            bg = self.graphs[bucket] = _BucketGraph(
                bucket, self._z, self._coef, self.model.spec, self._slab)
        bg.x[:n].copy_(xc)
        bg.x[n:].zero_()
        bg.replay()
        return bg.out[:n].clone()

    def score(self, x) -> Tensor:
        """Decision scores (B,) on the model's device for any batch size
        (``x`` on either device); pads to the bucket, chunks batches above
        the top bucket."""
        x = torch.as_tensor(x, dtype=torch.float32)
        B = x.shape[0]
        self.calls += 1
        if B == 0:
            return torch.zeros(0, dtype=torch.float32,
                               device=self.model.device)
        t0 = time.perf_counter()
        with _span("serve.score", batch=B):
            outs = []
            off = 0
            while off < B:
                n = min(B - off, self.max_batch)
                bucket = self._bucket_for(n)
                outs.append(self._score_chunk(x[off:off + n], bucket))
                self._seen.add(bucket)
                off += n
            out = outs[0] if len(outs) == 1 else torch.cat(outs)
        if self.metrics is not None:
            self.metrics.counter("serve.score.calls").inc()
            self.metrics.histogram("serve.score.wall_s").observe(
                time.perf_counter() - t0)
            self.metrics.histogram("serve.score.batch").observe(B)
        return out

    def predict(self, x) -> Tensor:
        return torch.sign(self.score(x))


# ---------------------------------------------------------------------------
# deadline microbatcher
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    rid: int
    x: Tensor           # (d,)
    t_arrival: float


@dataclasses.dataclass
class Completed:
    rid: int
    score: float
    t_arrival: float
    t_done: float

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival


class Batcher:
    """Queue/deadline microbatcher over a :class:`MicrobatchScorer`.

    ``submit`` enqueues one request; ``poll(now)`` flushes when the batch
    is full or the oldest request has waited past the deadline. All
    clocks are explicit arguments (``time.monotonic()`` by default) so
    replay is deterministic.
    """

    def __init__(self, scorer: MicrobatchScorer, max_batch: int = 64,
                 max_wait: float = 2e-3, faults=None,
                 metrics: MetricsRegistry | None = None):
        self.scorer = scorer
        self.max_batch = min(max_batch, scorer.max_batch)
        self.max_wait = max_wait
        # per-request latency histogram, queue-depth gauge, request /
        # batch counters; None records nothing
        self.metrics = metrics
        # fault plan: the "serve.flush" site fires before scoring; with a
        # virtual-clock plan (sleeper=None) an injected delay shifts the
        # batch's completion time instead of wall-sleeping
        self.faults = faults
        self._pending: list[_Pending] = []
        self._next_rid = 0
        self.batches: list[int] = []          # flushed batch sizes

    def submit(self, x, now: float | None = None) -> int:
        now = time.monotonic() if now is None else now
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(_Pending(rid, x, now))
        if self.metrics is not None:
            self.metrics.counter("serve.requests").inc()
            self.metrics.gauge("serve.queue_depth").set(len(self._pending))
        return rid

    def ready(self, now: float | None = None) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.max_batch:
            return True
        now = time.monotonic() if now is None else now
        return now - self._pending[0].t_arrival >= self.max_wait

    def flush(self, now: float | None = None) -> list[Completed]:
        """Score everything pending (at most max_batch) in ONE call."""
        if not self._pending:
            return []
        now = time.monotonic() if now is None else now
        batch, self._pending = (self._pending[:self.max_batch],
                                self._pending[self.max_batch:])
        if self.faults is not None:
            now += self.faults.site("serve.flush", batch=len(batch))
        with _span("serve.request_batch", batch=len(batch)):
            xb = torch.stack([torch.as_tensor(p.x, dtype=torch.float32)
                              for p in batch])
            scores = self.scorer.score(xb).cpu().tolist()
        self.batches.append(len(batch))
        done = [Completed(p.rid, s, p.t_arrival, now)
                for p, s in zip(batch, scores)]
        if self.metrics is not None:
            self.metrics.counter("serve.batches").inc()
            self.metrics.gauge("serve.queue_depth").set(len(self._pending))
            lat_h = self.metrics.histogram("serve.request.latency_s")
            for c in done:
                lat_h.observe(c.latency)
        return done

    def poll(self, now: float | None = None) -> list[Completed]:
        now = time.monotonic() if now is None else now
        out: list[Completed] = []
        while self.ready(now):
            out.extend(self.flush(now))
        return out


def serve_stream(batcher: Batcher, arrivals, *, tick: float | None = None
                 ) -> dict:
    """Replay an iterable of (t_arrival, x) events through the batcher.

    Virtual-clock replay: requests are submitted in arrival order and the
    batcher is polled at each arrival plus one final deadline tick, so
    results are independent of host timing. Returns
    {results, latencies, batches, mean_batch, p50, p95, p99} — the
    percentiles are exact nearest-rank
    (:func:`repro_torch.observe.percentile`).
    """
    results: list[Completed] = []
    t_last = 0.0
    for t, x in arrivals:
        results.extend(batcher.poll(t))
        batcher.submit(x, t)
        t_last = max(t_last, t)
    results.extend(batcher.poll(t_last + batcher.max_wait))
    lat = sorted(r.latency for r in results)
    n = len(lat)
    return {
        "results": results,
        "latencies": lat,
        "batches": list(batcher.batches),
        "mean_batch": (sum(batcher.batches) / len(batcher.batches)
                       if batcher.batches else 0.0),
        "p50": percentile(lat, 50) if n else 0.0,
        "p95": percentile(lat, 95) if n else 0.0,
        "p99": percentile(lat, 99) if n else 0.0,
    }


# ---------------------------------------------------------------------------
# SPMD: the SV slab sharded across the mesh
# ---------------------------------------------------------------------------

# each rank's slice of a padded SV slab, one per (model slab, mesh, axis):
# re-padding and re-slicing O(S·d) bytes per request batch would defeat
# the O(S/n_dev)-per-rank goal. Weakref-keyed (a live weakref proves the
# id) and FIFO-capped, like the reference's _SLAB_CACHE.
_SLAB_CACHE: dict = {}
_SLAB_CACHE_CAP = 8


def _sharded_slab(model: FittedODM, mesh, data_axis: str):
    """(z, coef, prepared slab) of this rank's slice, on its device."""
    key = (id(model.x_sv), mesh, data_axis)
    hit = _SLAB_CACHE.get(key)
    if hit is not None and hit[0]() is model.x_sv:
        return hit[1]
    n_dev = shd.axis_size(mesh, data_axis)
    r = shd.axis_index(mesh, data_axis)
    dev = shd.mesh_device(mesh)
    pad = -model.n_sv % n_dev
    n = (model.n_sv + pad) // n_dev
    z = torch.nn.functional.pad(model.x_sv, (0, 0, 0, pad))
    c = torch.nn.functional.pad(model.coef, (0, pad))
    z = z[r * n:(r + 1) * n].to(dev).contiguous()
    c = c[r * n:(r + 1) * n].to(dev).contiguous()
    slab = None if dev.type == "cpu" else \
        score_mod.prepare_slab(z, model.spec.name)
    if len(_SLAB_CACHE) >= _SLAB_CACHE_CAP:
        _SLAB_CACHE.pop(next(iter(_SLAB_CACHE)))
    _SLAB_CACHE[key] = (weakref.ref(model.x_sv), (z, c, slab))
    return z, c, slab


def score_sharded(model: FittedODM, x, mesh, data_axis: str = "data"
                  ) -> Tensor:
    """Decision scores with the SV slab sharded over ``mesh[data_axis]``.

    Every rank of the mesh calls this with the same request batch. The
    expansion is linear in the SVs, so each rank scores the batch against
    its slice (K2 on the card, counted in ``score_tiles.launches``; its
    plain version on the CPU) and one ``psum`` assembles f on every rank.
    The slab is padded to a multiple of the axis size with zero
    coefficients (zero rows contribute exactly nothing) and each rank's
    slice moved to its device ONCE per (model, mesh). A linear model
    scores ``x @ w`` replicated.
    """
    dev = shd.mesh_device(mesh)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    if model.w is not None:
        return x @ model.w.to(dev)
    z, c, slab = _sharded_slab(model, mesh, data_axis)
    spec = model.spec
    kw = dict(kind=spec.name, gamma=spec.gamma, degree=spec.degree,
              coef0=spec.coef0)
    if slab is None:
        part = score_mod.score_tiles(x.contiguous(), z, c, **kw)
    else:
        part = score_mod.launch_score(x.contiguous(), z, c, slab=slab, **kw)
        score_mod.score_tiles.launches.bump()
    return shd.psum(part, mesh, data_axis)
