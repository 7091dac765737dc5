"""Hierarchical span tracing exported as Chrome-trace / Perfetto JSON.

A copy of the pure-Python ``repro.observe.spans`` (the port imports
nothing of ``repro``); the spans it records are host-side only.

``span(name, **attrs)`` is a context manager that times a host-side
region of the training or serving path and records it as a complete
("ph": "X") Chrome trace event. Spans nest naturally: each event carries
its thread id and microsecond (ts, dur), and the Perfetto / chrome://
tracing UIs reconstruct the hierarchy by containment per thread — the
cascade's ``fit -> route -> cascade.level`` stack and the server's
``serve.request_batch -> serve.score`` stack need no explicit parent
pointers.

Zero cost when off: with no recorder installed, ``span()`` returns a
shared no-op context manager — no allocation beyond the call, no
timestamps, no locks — so production paths keep the instrumentation
inline unconditionally. The recorder is installed process-wide
(:func:`trace_ctx` / :func:`install`) rather than thread-locally because
instrumented regions span worker threads (the straggler scheduler's
partition attempts, the checkpoint writer); per-thread *nesting* comes
from the per-event ``tid``.

A device profiler sees kernels; these spans see the host-side
orchestration — levels, segments, request batches — that the device
timeline cannot name.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Span", "SpanRecorder", "span", "trace_ctx", "install",
           "current_recorder"]


class _NoopSpan:
    """Shared do-nothing context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()

#: the process-wide recorder; None means tracing is off (the fast path)
_ACTIVE: "SpanRecorder | None" = None


class Span:
    """One in-flight span; records itself into the recorder on exit."""

    __slots__ = ("recorder", "name", "attrs", "t0")

    def __init__(self, recorder: "SpanRecorder", name: str, attrs: dict):
        self.recorder = recorder
        self.name = name
        self.attrs = attrs
        self.t0 = 0

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.recorder.add_span(self.name, self.t0 / 1e3,
                               (t1 - self.t0) / 1e3,
                               tid=threading.get_ident(), **self.attrs)
        return False


class SpanRecorder:
    """Collects finished spans as Chrome trace events (thread-safe)."""

    def __init__(self):
        self._events: list[dict] = []
        self._lock = threading.Lock()

    def add_span(self, name: str, ts_us: float, dur_us: float, *,
                 tid: int | str = 0, **attrs) -> None:
        """Append one complete event. ``ts_us``/``dur_us`` are
        microseconds on any monotonic clock base (real spans use
        ``perf_counter``; virtual-clock replays may supply their own)."""
        event = {"name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
                 "pid": os.getpid(), "tid": tid}
        if attrs:
            event["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            self._events.append(event)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def spans(self, name: str | None = None) -> list[dict]:
        """Recorded events, optionally filtered by span name."""
        evs = self.events()
        return evs if name is None else [e for e in evs
                                         if e["name"] == name]

    def to_chrome_trace(self) -> dict:
        """The Chrome trace JSON object (load in Perfetto / about:tracing)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str | os.PathLike) -> str:
        """Write the trace JSON; parent directories are created."""
        path = os.fspath(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    try:
        return float(v)            # jnp/np scalars
    except (TypeError, ValueError):
        return repr(v)


def span(name: str, **attrs):
    """Time a host-side region when a recorder is installed; otherwise a
    shared no-op (the zero-cost-when-off contract)."""
    rec = _ACTIVE
    if rec is None:
        return _NOOP
    return Span(rec, name, attrs)


def current_recorder() -> SpanRecorder | None:
    return _ACTIVE


class install:
    """Install ``recorder`` process-wide for the ``with`` block.

    Re-entrant in the stacking sense: the previous recorder (usually
    None) is restored on exit, so an outer fit trace survives an inner
    scoped one.
    """

    def __init__(self, recorder: SpanRecorder):
        self.recorder = recorder
        self._prev: SpanRecorder | None = None

    def __enter__(self) -> SpanRecorder:
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self.recorder
        return self.recorder

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


class trace_ctx:
    """Record spans for the block and export ``<trace_dir>/trace.json``.

    No-op when ``trace_dir`` is None (mirrors ``profile_ctx``), so call
    sites can take a ``trace_dir=`` kwarg without branching. The export
    happens even if the block raises — a preempted fit still leaves its
    partial trace on disk.
    """

    FILENAME = "trace.json"

    def __init__(self, trace_dir: str | os.PathLike | None):
        self.trace_dir = trace_dir
        self.recorder: SpanRecorder | None = None
        self._install: install | None = None

    def __enter__(self) -> SpanRecorder | None:
        if self.trace_dir is None:
            return None
        self.recorder = SpanRecorder()
        self._install = install(self.recorder)
        self._install.__enter__()
        return self.recorder

    def __exit__(self, *exc):
        if self._install is not None:
            self._install.__exit__(*exc)
            self.recorder.export(
                os.path.join(os.fspath(self.trace_dir), self.FILENAME))
        return False
