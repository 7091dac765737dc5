"""Process-wide counters: kernel launches and level solves.

Port of the counter half of ``repro.analysis.invariants`` (:class:`Counter`,
:func:`counter`, :func:`counters`); the declared-invariant battery, which
walks jaxprs and Pallas plans, has no counterpart in the port. Every
kernel wrapper holds its counter as ``<wrapper>.launches`` =
``counter("launch.<wrapper>")`` and bumps it where it launches its
kernel; a captured CUDA graph bumps its kernel's counter on each replay;
``sodm`` counts its level solves in ``counter("sodm.level_solve")``.
Readers (``MetricsRegistry.snapshot(include_counters=True)``,
``chip_smoke.py``) go through :func:`counters`.

Import discipline: stdlib only, so every layer of the port can import it.
"""
from __future__ import annotations

__all__ = ["Counter", "counter", "counters"]


class Counter:
    """A named process-wide event count."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def bump(self, n: int = 1) -> None:
        self.count += n

    def reset(self) -> None:
        self.count = 0

    def __repr__(self) -> str:
        return f"Counter({self.name!r}, count={self.count})"


_COUNTERS: dict[str, Counter] = {}


def counter(name: str) -> Counter:
    """Get-or-create the process-wide counter ``name``."""
    got = _COUNTERS.get(name)
    if got is None:
        got = _COUNTERS[name] = Counter(name)
    return got


def counters() -> dict[str, Counter]:
    return dict(_COUNTERS)
