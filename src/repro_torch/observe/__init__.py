"""repro_torch.observe — host-side span tracing (port of the spans leg of
``repro.observe``); trackers are duck-typed (``log_metrics(step, dict)``).
"""
from repro_torch.observe.spans import (Span, SpanRecorder, current_recorder,
                                       install, span, trace_ctx)

__all__ = ["Span", "SpanRecorder", "span", "trace_ctx", "install",
           "current_recorder"]
