"""Metric instruments: counters, gauges, fixed-bucket histograms.

A copy of the pure-Python ``repro.observe.instruments`` (the port imports
nothing of ``repro``): stdlib only, so the serving hot path can feed
instruments without touching device state. Three instrument kinds:

* :class:`Counter` — monotone event count (requests served, batches);
* :class:`Gauge` — last-value-wins scalar (queue depth);
* :class:`Histogram` — fixed bucket boundaries for cheap distribution
  summaries PLUS the raw observations, so ``p50/p95/p99`` are the exact
  nearest-rank percentiles rather than bucket-midpoint estimates. The
  raw store is capped (``max_samples``, default 65536) with
  skip-the-oldest downsampling beyond the cap.

:class:`MetricsRegistry` is the instrument namespace. It is itself a
tracker (``log_metrics`` observes every numeric value into the histogram
of the same name), so it composes with any tracker backend, and it
*drains* back through the protocol: ``registry.drain(tracker, step)``
emits one flat snapshot record (``<name>.count``, ``<name>.p99``, ...).
``snapshot(include_counters=True)`` folds in the process-wide
:mod:`repro_torch.analysis.invariants` counters (each kernel's launches,
the level solves).

The shared :func:`percentile` helper is THE nearest-rank definition used
by both the histograms and ``serve.serve_stream``.
"""
from __future__ import annotations

import bisect
import threading
from typing import Mapping, Sequence

from repro_torch.analysis import invariants as inv

__all__ = ["percentile", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "DEFAULT_BUCKETS"]


def percentile(values: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile (no interpolation).

    ``q`` in [0, 100]. The nearest-rank definition: the smallest value
    with at least ``ceil(q/100 * n)`` observations at or below it —
    index ``ceil(q/100 * n) - 1`` of the sorted sample, clamped to the
    valid range (q=0 gives the minimum, q=100 the maximum). Sorts a copy
    when the input is unsorted; callers holding an already-sorted list
    pass it straight through cheaply.
    """
    n = len(values)
    if n == 0:
        raise ValueError("percentile of an empty sequence")
    if not 0 <= q <= 100:
        raise ValueError(f"q must be in [0, 100], got {q}")
    vals = list(values)
    if any(vals[i] > vals[i + 1] for i in range(n - 1)):
        vals.sort()
    rank = -(-q * n // 100)            # ceil(q/100 * n) in exact int math
    return vals[max(0, min(n - 1, int(rank) - 1))]


class Counter:
    """Monotone event counter."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> dict:
        return {f"{self.name}.count": self.value}


class Gauge:
    """Last-value-wins scalar with min/max watermarks."""

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None
        self.min: float | None = None
        self.max: float | None = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.value = v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def snapshot(self) -> dict:
        if self.value is None:
            return {}
        return {self.name: self.value, f"{self.name}.min": self.min,
                f"{self.name}.max": self.max}


#: default boundaries — exponential, covering 100µs .. ~100s latencies
#: and small-integer depths/counts alike
DEFAULT_BUCKETS = tuple(10.0 ** (e / 2) for e in range(-8, 5))


class Histogram:
    """Fixed-bucket histogram with exact percentile readout.

    ``buckets`` are the upper bounds of the counting buckets (a final
    +inf bucket is implicit). ``observe`` is O(log buckets); the raw
    sample store backing the exact percentiles is capped at
    ``max_samples`` by keeping every k-th observation once full (the
    bucket counts always remain exact).
    """

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 max_samples: int = 65536):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.n = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self.max_samples = max_samples
        self.samples: list[float] = []
        self._stride = 1
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect.bisect_left(self.buckets, v)] += 1
            self.n += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if self.n % self._stride == 0:
                self.samples.append(v)
                if len(self.samples) >= self.max_samples:
                    # halve the resident sample set, double the stride
                    self.samples = self.samples[::2]
                    self._stride *= 2

    def percentile(self, q: float) -> float:
        with self._lock:
            sample = list(self.samples)
        return percentile(sample, q)

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def snapshot(self) -> dict:
        if self.n == 0:
            return {f"{self.name}.count": 0}
        return {
            f"{self.name}.count": self.n,
            f"{self.name}.mean": self.mean,
            f"{self.name}.min": self.min,
            f"{self.name}.max": self.max,
            f"{self.name}.p50": self.percentile(50),
            f"{self.name}.p95": self.percentile(95),
            f"{self.name}.p99": self.percentile(99),
        }


class MetricsRegistry:
    """Get-or-create namespace of instruments; a draining Tracker backend.

    As a tracker (``log_metrics``): every numeric metric value is
    observed into the histogram of the same name, so wiring a registry
    into ``ODMEstimator.fit(tracker=...)`` — alone or inside a
    ``CompositeTracker`` — accumulates per-level solve-time / KKT /
    throughput distributions for free.

    As a source (``drain``): one flat snapshot of every instrument is
    emitted through any other tracker, which is how histogram
    percentiles reach jsonl files and ``BENCH_*.json`` records.
    """

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, *args, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"instrument {name!r} already exists as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets)

    def instruments(self) -> dict[str, object]:
        with self._lock:
            return dict(self._instruments)

    # -- Tracker protocol (accumulating backend) ----------------------------

    def log_metrics(self, step: int, metrics: Mapping[str, object]) -> None:
        del step
        for k, v in metrics.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.histogram(k).observe(v)

    # -- draining -----------------------------------------------------------

    def snapshot(self, include_counters: bool = False) -> dict:
        """One flat {name.stat: value} dict over every instrument.

        ``include_counters=True`` folds in the process-wide
        :mod:`repro_torch.analysis.invariants` counters as
        ``counter.<name>.count`` — kernel launches (``launch.<kernel>``,
        a captured graph's replays included) and level solves — so a
        drained record carries the structural accounting next to the
        latency distributions.
        """
        out: dict[str, object] = {}
        for inst in self.instruments().values():
            out.update(inst.snapshot())
        if include_counters:
            for name, c in inv.counters().items():
                out[f"counter.{name}.count"] = c.count
        return out

    def drain(self, tracker, step: int = 0, *,
              include_counters: bool = False) -> dict:
        """Emit :meth:`snapshot` through ``tracker.log_metrics`` (any
        backend of the Tracker protocol); returns the snapshot."""
        snap = self.snapshot(include_counters=include_counters)
        tracker.log_metrics(step, snap)
        return snap
