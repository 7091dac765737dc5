"""repro_torch.observe — telemetry (port of ``repro.observe``): trackers,
spans, instruments, the device profiler hook and the perf trend.

* **Trackers** (:mod:`~repro_torch.observe.tracker`): anything with
  ``log_metrics(step, metrics)``; the estimator feeds one per-level
  and per-epoch statistics and a final fit summary.
* **Spans** (:mod:`~repro_torch.observe.spans`): ``span(name, **attrs)``
  times host-side regions; ``trace_ctx(dir)`` exports them as Chrome
  trace JSON. Zero cost when no recorder is installed.
* **Profiler** (:mod:`~repro_torch.observe.profiler`):
  ``profile_ctx(dir, device)`` records ``torch.profiler`` CPU and CUDA
  activity into a Chrome trace, the kernels' device time included.
* **Instruments** (:mod:`~repro_torch.observe.instruments`): counters,
  gauges and histograms with exact nearest-rank percentiles.
* **Trend** (:mod:`~repro_torch.observe.trend`): ``BENCH_*.json``
  records against committed baselines.
"""
from repro_torch.observe.tracker import (
    CompositeTracker,
    InMemoryTracker,
    JsonlTracker,
    Tracker,
    read_jsonl,
)
from repro_torch.observe.profiler import profile_ctx
from repro_torch.observe.spans import (
    Span,
    SpanRecorder,
    current_recorder,
    install,
    span,
    trace_ctx,
)
from repro_torch.observe.instruments import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile,
)
from repro_torch.observe import trend

__all__ = [
    "Tracker",
    "InMemoryTracker",
    "JsonlTracker",
    "CompositeTracker",
    "read_jsonl",
    "profile_ctx",
    "Span",
    "SpanRecorder",
    "span",
    "trace_ctx",
    "install",
    "current_recorder",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "percentile",
    "DEFAULT_BUCKETS",
    "trend",
]
