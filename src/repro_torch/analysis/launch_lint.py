"""Declarative launch lint: record a run's dispatch plan, check invariants.

Port of ``repro.analysis.jaxpr_lint``. The reference walks the jaxpr of a
traced function before anything runs; a PyTorch program has no such plan
ahead of time, so the port records one while a zero-argument thunk runs
(:func:`record`) and flattens it into :class:`Site`\\ s, each with the
structural path of host spans open at that moment (``observe.spans``,
e.g. ``fit/route.dsvrg/dsvrg.epoch``):

* **kernel sites** come from the public kernel wrappers, on both
  branches: each wrapper's one ``on_cpu(..., kernel=name)`` call (the
  point where it picks its plain version or its kernel) records the
  wrapper's name, the device type and the argument shapes. A CPU run
  therefore records the dispatch plan the card launches. The kernels are
  launched through ``ctypes``, which PyTorch's dispatcher never sees, so
  no dispatch mode could find them; a replayed CUDA graph makes no host
  call at all, so the serving bucket graph records its site where it
  bumps ``score_tiles.launches``. The names are those of the
  ``launch.<name>`` counters, which stay card-only;
* **op sites** come from a ``TorchDispatchMode`` installed only while
  recording (nothing is installed otherwise): host syncs
  (``aten._local_scalar_dense`` behind ``.item()``/``float(t)``/
  ``bool(t)``, ``aten.equal``, a copy from the card to the host) and
  gathers (``aten.index.Tensor``, ``aten.gather``, ``aten.index_select``,
  ``aten.take``);
* **collective sites** come from ``sharding``'s one collective hook,
  where the ``collective.<op>`` counters are bumped;
* **span sites**: every span that opens, with its attributes, so rules
  can count per span instance (per level, per epoch).

Rules mirror the reference's: :func:`max_launches` (launch budgets),
:func:`expect_launches_per` (the counterpart of ``expect_scan``: so many
dispatches of a kernel in each instance of a span), :func:`gather_free`,
:func:`no_host_sync_in` and :func:`no_collectives_in` (the counterparts
of the in-loop rules, scoped by span rather than by loop frame).
Entry points: :func:`record` (or :func:`run`, which also returns the
thunk's result), :func:`lint`, :func:`check` (raises
:class:`InvariantViolation` with a report) and :func:`count`.

Import discipline: stdlib only at import time, so the kernel layer can
import the hook; ``torch`` and ``observe.spans`` are imported when a
recording starts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

__all__ = [
    "InvariantViolation", "Site", "Rule", "Violation", "record", "run",
    "lint", "check", "count", "per_span", "max_launches",
    "expect_launches_per", "gather_free", "no_host_sync_in",
    "no_collectives_in", "KERNEL", "OP", "COLLECTIVE", "SPAN",
    "HOST_SYNC_OPS", "GATHER_OPS", "note_kernel", "note_collective",
]


class InvariantViolation(AssertionError):
    """A declared plan-level invariant does not hold."""


KERNEL, OP, COLLECTIVE, SPAN = "kernel", "op", "collective", "span"

#: aten ops that make the host wait for the device (a copy from the card
#: to the host counts too, see ``_OpMode``)
HOST_SYNC_OPS = frozenset({"aten._local_scalar_dense.default",
                           "aten.equal.default"})

#: dynamic-indexing ops a gather-free path must not contain
GATHER_OPS = frozenset({"aten.index.Tensor", "aten.gather.default",
                        "aten.index_select.default", "aten.take.default"})

_COPY_OPS = frozenset({"aten._to_copy.default", "aten.copy_.default"})


@dataclasses.dataclass(frozen=True)
class Site:
    """One dispatch (or span opening) of a recorded run.

    ``kind`` is one of :data:`KERNEL`, :data:`OP`, :data:`COLLECTIVE`,
    :data:`SPAN`; ``name`` the kernel wrapper (``launch.<name>``), the
    aten op, the collective or the span; ``path`` the names of the spans
    open around it, outermost first, and ``frames`` their ids. A span
    site's ``sid`` is its own id and ``attrs`` its attributes."""

    kind: str
    name: str
    path: tuple[str, ...] = ()
    frames: tuple[int, ...] = ()
    device: str = ""
    shapes: tuple = ()
    sid: int = 0
    attrs: dict = dataclasses.field(default_factory=dict, compare=False,
                                    hash=False)

    @property
    def where(self) -> str:
        return "/".join(self.path) if self.path else "<top>"

    def within(self, span: str) -> bool:
        return span in self.path

    def __str__(self) -> str:
        dev = f"[{self.device}]" if self.device else ""
        return f"{self.where}:{self.kind}:{self.name}{dev}"


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

class _Recording:
    def __init__(self):
        self.sites: list[Site] = []

    def _where(self, drop_last: bool = False):
        st = _spans.stack()
        if drop_last:
            st = st[:-1]
        return tuple(s.name for s in st), tuple(s.sid for s in st)

    def kernel(self, name: str, device: str, tensors) -> None:
        path, frames = self._where()
        self.sites.append(Site(KERNEL, name, path, frames, device,
                               tuple(tuple(t.shape) for t in tensors)))

    def op(self, name: str, device: str) -> None:
        path, frames = self._where()
        self.sites.append(Site(OP, name, path, frames, device))

    def collective(self, op: str, nbytes: int) -> None:
        path, frames = self._where()
        self.sites.append(Site(COLLECTIVE, op, path, frames,
                               shapes=(nbytes,)))

    def span(self, s) -> None:
        path, frames = self._where(drop_last=True)
        self.sites.append(Site(SPAN, s.name, path, frames, sid=s.sid,
                               attrs=dict(s.attrs)))


#: the recording in progress; None when nothing records (the fast path:
#: every hook is one global test)
ACTIVE: _Recording | None = None
_spans = None
_MODE_CLS = None


def note_kernel(name: str, device: str, tensors=()) -> None:
    """Record a kernel dispatch (the wrappers' hook; a no-op when
    nothing records)."""
    if ACTIVE is not None:
        ACTIVE.kernel(name, device, tensors)


def note_collective(op: str, nbytes: int) -> None:
    """Record a collective (``sharding``'s hook)."""
    if ACTIVE is not None:
        ACTIVE.collective(op, nbytes)


def _op_mode_cls():
    global _MODE_CLS
    if _MODE_CLS is None:
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        def _device(args) -> str:
            for a in args:
                if isinstance(a, torch.Tensor):
                    return a.device.type
            return ""

        def _to_host(name, args, kwargs) -> bool:
            if name == "aten._to_copy.default":
                dst = kwargs.get("device")
                return (args[0].device.type == "cuda" and dst is not None
                        and torch.device(dst).type == "cpu")
            return (args[0].device.type == "cpu"
                    and args[1].device.type == "cuda")

        class _OpMode(TorchDispatchMode):
            def __init__(self, rec: _Recording):
                super().__init__()
                self.rec = rec

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = str(func)
                if name in HOST_SYNC_OPS or name in GATHER_OPS:
                    self.rec.op(name, _device(args))
                elif name in _COPY_OPS and _to_host(name, args, kwargs):
                    self.rec.op(name, "cuda")
                return func(*args, **kwargs)

        _MODE_CLS = _OpMode
    return _MODE_CLS


def run(thunk: Callable[[], object]) -> tuple[object, list[Site]]:
    """Run ``thunk`` while recording; returns (its result, the sites).
    A span recorder is installed for the run when none is, so spans name
    the sites' paths; a ``trace_dir`` fit inside installs its own and the
    stack goes on."""
    global ACTIVE, _spans
    from repro_torch.observe import spans
    _spans = spans
    rec = _Recording()
    prev, prev_listener = ACTIVE, spans._LISTENER
    own = spans.current_recorder() is None
    ACTIVE, spans._LISTENER = rec, rec.span
    try:
        inst = spans.install(spans.SpanRecorder()) if own else None
        if inst is not None:
            inst.__enter__()
        try:
            with _op_mode_cls()(rec):
                out = thunk()
        finally:
            if inst is not None:
                inst.__exit__(None, None, None)
    finally:
        ACTIVE, spans._LISTENER = prev, prev_listener
    return out, rec.sites


def record(thunk: Callable[[], object]) -> list[Site]:
    """The flat site list of one run of the zero-argument ``thunk``."""
    return run(thunk)[1]


def _sites_of(target) -> list[Site]:
    return record(target) if callable(target) else list(target)


def count(target, name: str, *, kind: str = KERNEL,
          within: str | None = None, device: str | None = None) -> int:
    """Sites of ``kind`` named ``name`` (inside span ``within``, on
    ``device``) in ``target`` (a thunk, which is run, or a site list)."""
    return sum(1 for s in _sites_of(target)
               if s.kind == kind and s.name == name
               and (within is None or s.within(within))
               and (device is None or s.device == device))


def per_span(sites: Sequence[Site], span: str, name: str, *,
             kind: str = KERNEL) -> list[tuple[dict, int]]:
    """For each opening of span ``span``, in order: (its attributes, the
    number of ``kind`` sites named ``name`` inside it)."""
    out = []
    for sp in sites:
        if sp.kind == SPAN and sp.name == span:
            n = sum(1 for s in sites if s.kind == kind and s.name == name
                    and sp.sid in s.frames)
            out.append((sp.attrs, n))
    return out


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """A declarative invariant over the flattened site list."""

    name: str
    description: str
    check: Callable[[list[Site]], list[str]] = dataclasses.field(
        compare=False)

    def run(self, sites: list[Site]) -> list[Violation]:
        return [Violation(rule=self.name, message=m)
                for m in self.check(sites)]


def max_launches(kernel: str, n: int, *, within: str | None = None,
                 name: str | None = None) -> Rule:
    """Launch budget: at most ``n`` dispatches of ``kernel`` (inside
    span ``within`` if given)."""

    def chk(sites: list[Site]) -> list[str]:
        hits = [s for s in sites if s.kind == KERNEL and s.name == kernel
                and (within is None or s.within(within))]
        if len(hits) > n:
            at = ", ".join(str(s) for s in hits[:8])
            return [f"{len(hits)} x {kernel} dispatched, budget is {n} "
                    f"(at: {at}{', ...' if len(hits) > 8 else ''})"]
        return []

    return Rule(name=name or f"max_launches_{kernel}_{n}",
                description=f"at most {n} {kernel} dispatches", check=chk)


def expect_launches_per(span: str, kernel: str, n: int = 1, *,
                        name: str | None = None) -> Rule:
    """Exactly ``n`` dispatches of ``kernel`` inside every opening of
    span ``span``, and at least one such opening — the port's
    ``expect_scan`` ("one epoch-kernel launch an epoch")."""

    def chk(sites: list[Site]) -> list[str]:
        got = per_span(sites, span, kernel)
        if not got:
            return [f"no {span!r} span was opened"]
        bad = [(a, k) for a, k in got if k != n]
        if bad:
            return [f"expected {n} x {kernel} in each {span!r} span, found "
                    f"{[k for _, k in got]} over {len(got)} span(s)"]
        return []

    return Rule(name=name or f"expect_{kernel}_{n}_per_{span}",
                description=f"{n} {kernel} dispatch(es) per {span}",
                check=chk)


def _forbid_ops(pset: frozenset, *, name: str, within: str | None,
                reason: str, kind: str = OP,
                allow: Sequence[str] = ()) -> Rule:
    allowed = frozenset(allow)

    def chk(sites: list[Site]) -> list[str]:
        why = f" — {reason}" if reason else ""
        return [f"{s}{why}" for s in sites
                if s.kind == kind and (not pset or s.name in pset)
                and s.name not in allowed
                and (within is None or s.within(within))]

    where = f" inside {within!r} spans" if within else ""
    return Rule(name=name, description=f"forbids {kind} {sorted(pset)}"
                f"{where}", check=chk)


def gather_free(within: str | None = None) -> Rule:
    """No gather (inside span ``within`` if given): a served score path
    never re-applies the partition permutation per call."""
    return _forbid_ops(
        GATHER_OPS, name="gather_free", within=within,
        reason="this path is pinned gather-free (permutations are applied "
               "once at compile_model time, never per call)")


def no_host_sync_in(span: str | None) -> Rule:
    """No host sync inside span ``span`` (anywhere when ``None``): one
    device-to-host round trip per iteration serializes the loop."""
    return _forbid_ops(
        HOST_SYNC_OPS | _COPY_OPS,
        name=f"no_host_sync_in_{span}" if span else "no_host_sync",
        within=span, reason="each iteration would wait for the device")


def no_collectives_in(span: str, allow: Sequence[str] = ()) -> Rule:
    """No collective inside span ``span`` (the hoisting trap: an
    all-gather of a loop-invariant slab inside an epoch pays its wire
    bytes once per epoch). ``allow`` names collectives that are
    legitimately per-iteration (the sharded epoch's ``psum``)."""
    return _forbid_ops(
        frozenset(), kind=COLLECTIVE, name=f"no_collectives_in_{span}",
        within=span, allow=allow,
        reason="hoist loop-invariant collectives above the loop")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint(target, rules: Sequence[Rule]) -> list[Violation]:
    """Run ``rules`` over the sites of ``target`` (a zero-argument thunk,
    which is run once, or a site list); returns all violations."""
    sites = _sites_of(target)
    out: list[Violation] = []
    for rule in rules:
        out.extend(rule.run(sites))
    return out


def check(target, rules: Sequence[Rule], *, subject: str = "plan") -> None:
    """:func:`lint` and raise :class:`InvariantViolation` on violations."""
    violations = lint(target, rules)
    if violations:
        lines = "\n".join(f"  {v}" for v in violations)
        raise InvariantViolation(
            f"{subject}: {len(violations)} launch invariant violation(s):\n"
            f"{lines}")
