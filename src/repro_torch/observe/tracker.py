"""Metric trackers: the ``log_metrics(step, dict)`` protocol + backends.

Port of ``repro.observe.tracker`` (stdlib only; the port imports nothing
of ``repro``). Trainers emit flat ``{name: scalar}`` dicts at integer
steps and never know where they go. Backends: an in-memory list (tests,
notebook inspection) and an append-only jsonl file (survives preemption;
each line is self-delimiting, so a half-written tail line from a killed
process is skipped by :func:`read_jsonl` rather than corrupting the
history). :class:`CompositeTracker` fans out to several.

Metric values are coerced to plain Python scalars at the logging
boundary: ``float`` of a 0-d tensor is one host sync (on the card it
waits for the value), as ``float(jnp_scalar)`` is in the reference, and
it happens here only, so backends never hold device tensors alive and
jsonl output is always serialisable. The same stream logged through this
module and through the reference's writes the same bytes.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Mapping, Protocol, runtime_checkable

__all__ = ["Tracker", "InMemoryTracker", "JsonlTracker", "CompositeTracker",
           "read_jsonl"]


@runtime_checkable
class Tracker(Protocol):
    """Anything with ``log_metrics(step, metrics)`` is a tracker."""

    def log_metrics(self, step: int, metrics: Mapping[str, object]) -> None:
        ...


def _scalarize(value: object) -> object:
    """Coerce metric values to json-safe Python scalars."""
    if isinstance(value, (str, bool, type(None))):
        return value
    if isinstance(value, int):
        return value
    try:
        return float(value)          # 0-d tensors, numpy scalars, floats
    except (TypeError, ValueError, RuntimeError):
        return repr(value)


class InMemoryTracker:
    """Records ``(step, metrics)`` pairs on ``self.steps`` for assertions."""

    def __init__(self):
        self.steps: list[tuple[int, dict]] = []

    def log_metrics(self, step: int, metrics: Mapping[str, object]) -> None:
        self.steps.append(
            (int(step), {k: _scalarize(v) for k, v in metrics.items()}))

    def series(self, name: str) -> list[object]:
        """All logged values of metric ``name``, in step order."""
        return [m[name] for _, m in self.steps if name in m]

    def latest(self) -> dict:
        return self.steps[-1][1] if self.steps else {}


class JsonlTracker:
    """Appends one ``{"step": ..., **metrics}`` json object per line.

    The file handle is opened lazily on the first ``log_metrics`` and
    kept for the tracker's lifetime. Every line is flushed and fsynced
    before ``log_metrics`` returns, so a preempted process loses at most
    its final partial line, which :func:`read_jsonl` tolerates. Call
    :meth:`close` (or use the tracker as a context manager) to release
    the handle; a closed tracker reopens if logged to again.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._file = None

    def log_metrics(self, step: int, metrics: Mapping[str, object]) -> None:
        record = {"step": int(step)}
        record.update({k: _scalarize(v) for k, v in metrics.items()})
        if self._file is None:
            self._file = open(self.path, "a")
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        os.fsync(self._file.fileno())

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "JsonlTracker":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __del__(self):  # best-effort; every line is already durable
        self.close()


def read_jsonl(path: str | os.PathLike) -> list[dict]:
    """Load a JsonlTracker file, skipping a torn final line if present."""
    records: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue          # torn tail line from a killed writer
    return records


class CompositeTracker:
    """Fans ``log_metrics`` out to several trackers."""

    def __init__(self, trackers: Iterable[Tracker]):
        self.trackers = list(trackers)

    def log_metrics(self, step: int, metrics: Mapping[str, object]) -> None:
        for t in self.trackers:
            t.log_metrics(step, metrics)
