"""repro_torch.observe — host-side telemetry (port of ``repro.observe``):
span tracing and metric instruments. Trackers are duck-typed
(``log_metrics(step, dict)``); a :class:`MetricsRegistry` is one.
"""
from repro_torch.observe.instruments import (DEFAULT_BUCKETS, Counter, Gauge,
                                             Histogram, MetricsRegistry,
                                             percentile)
from repro_torch.observe.spans import (Span, SpanRecorder, current_recorder,
                                       install, span, trace_ctx)

__all__ = ["Span", "SpanRecorder", "span", "trace_ctx", "install",
           "current_recorder", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "percentile", "DEFAULT_BUCKETS"]
