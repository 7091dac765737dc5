"""Deterministic fault injection — the chaos-test substrate.

A copy of the pure-Python ``repro.distributed.faults`` (the port imports
nothing of ``repro``). The port's loops fire the same sites.

Distributed kernel-machine practice treats worker loss as the common
case, not the exception: a long-running cascade solve WILL be preempted,
a checkpoint writer WILL die between the temp write and the atomic
rename, and one partition WILL straggle. Proving the recovery paths work
requires *injecting* those faults deterministically, from tests, without
subprocess gymnastics (killing real processes is slow, flaky, and hides
the failure point).

The production loops are instrumented with named **sites** — points where
a preemption or delay can strike:

====================== ====================================================
site                   where it fires
====================== ====================================================
``cascade.level``      top of each SODM level solve (``level=``, ``K=``)
``cascade.partition``  before each straggler-scheduler partition attempt
                       (``partition=``, ``attempt=``)
``dsvrg.segment``      before each DSVRG epoch segment (``epoch=``)
``checkpoint.pre_rename``  inside ``CheckpointManager._write``, between
                       the fsync'd temp write and the atomic rename —
                       the crash window (``step=``)
``serve.flush``        before a ``Batcher`` flush scores (``batch=``)
``data.prefetch``      inside the streaming ``PrefetchLoader``, before a
                       shard read starts (``shard=``) — a kill surfaces
                       out of the loader's iteration, a delay simulates
                       slow storage
``cascade.shard``      before the streaming cascade consumes an arrived
                       level-0 leaf (``shard=`` — the leaf index)
====================== ====================================================

A :class:`FaultPlan` holds match rules against those sites:

    plan = FaultPlan().kill_at_level(2)          # die solving level 2
    plan = FaultPlan().kill_mid_checkpoint()     # die in the crash window
    plan = FaultPlan().delay_partition(3, 0.05)  # partition 3 straggles

``site()`` is called by the instrumented loop with the site name and
keyword facts; a matching ``kill`` rule raises :class:`Preemption` (the
simulated SIGKILL — it propagates out of ``fit`` exactly like a driver
death), a matching ``delay`` rule sleeps through the plan's injected
``sleeper`` (or, with ``sleeper=None``, just *returns* the delay seconds
so virtual-clock consumers like ``serve_stream`` can add it to their
clock instead of wall-sleeping). Rules carry a fire ``count`` and are
spent after it — a killed-and-retried attempt succeeds, which is exactly
the recovery semantics under test. Everything is deterministic: the same
plan against the same loop fires at the same site every time, and
``plan.fired`` records what struck where.

``None`` (no plan) is the production default everywhere; instrumentation
costs one ``is None`` check per site.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


class Preemption(RuntimeError):
    """The simulated driver/worker death raised by a ``kill`` rule."""

    def __init__(self, site: str, info: dict):
        self.site = site
        self.info = dict(info)
        super().__init__(f"injected preemption at site {site!r} ({info})")


@dataclasses.dataclass
class _Rule:
    site: str
    match: tuple[tuple[str, object], ...]   # (key, value) facts, all must hold
    action: str                             # "kill" | "delay"
    seconds: float = 0.0
    remaining: int = 1                      # fires left; spent at 0

    def matches(self, site: str, info: dict) -> bool:
        if self.remaining <= 0 or site != self.site:
            return False
        return all(info.get(k) == v for k, v in self.match)


class FaultPlan:
    """A deterministic schedule of injected faults (see module docs).

    ``sleeper`` implements delay rules — ``time.sleep`` by default,
    ``None`` for virtual-clock consumers (no wall sleep; ``site()``
    returns the delay seconds either way so callers can advance their
    own clocks).
    """

    def __init__(self, sleeper: Callable[[float], None] | None = time.sleep):
        self.sleeper = sleeper
        self.rules: list[_Rule] = []
        self.fired: list[tuple[str, str, dict]] = []   # (action, site, info)

    # -- rule construction (chainable) --------------------------------------

    def kill(self, site: str, *, count: int = 1, **match) -> "FaultPlan":
        """Raise :class:`Preemption` the first ``count`` matching visits."""
        self.rules.append(_Rule(site=site, match=tuple(sorted(match.items())),
                                action="kill", remaining=count))
        return self

    def delay(self, site: str, seconds: float, *, count: int = 1,
              **match) -> "FaultPlan":
        """Stall ``seconds`` on the first ``count`` matching visits."""
        self.rules.append(_Rule(site=site, match=tuple(sorted(match.items())),
                                action="delay", seconds=float(seconds),
                                remaining=count))
        return self

    # the ISSUE's three chaos verbs, spelled out

    def kill_at_level(self, level: int, *, count: int = 1) -> "FaultPlan":
        """Preempt the driver while it is solving cascade level ``level``."""
        return self.kill("cascade.level", level=level, count=count)

    def kill_mid_checkpoint(self, *, count: int = 1) -> "FaultPlan":
        """Preempt inside the checkpoint crash window (post-write,
        pre-rename) — the previously committed step must survive."""
        return self.kill("checkpoint.pre_rename", count=count)

    def delay_partition(self, partition: int, seconds: float, *,
                        count: int = 1) -> "FaultPlan":
        """Make one partition solve straggle (speculation-trigger test)."""
        return self.delay("cascade.partition", seconds, partition=partition,
                          count=count)

    def kill_at_epoch(self, epoch: int, *, count: int = 1) -> "FaultPlan":
        """Preempt the DSVRG driver before the segment starting at
        ``epoch``."""
        return self.kill("dsvrg.segment", epoch=epoch, count=count)

    def kill_at_shard(self, shard: int, *, count: int = 1) -> "FaultPlan":
        """Preempt the streaming cascade before it consumes leaf
        ``shard`` (mid-stream driver death)."""
        return self.kill("cascade.shard", shard=shard, count=count)

    def delay_shard_read(self, shard: int, seconds: float, *,
                         count: int = 1) -> "FaultPlan":
        """Make one shard read straggle inside the prefetch loader
        (slow-storage simulation)."""
        return self.delay("data.prefetch", seconds, shard=shard,
                          count=count)

    # -- the hook the instrumented loops call --------------------------------

    def site(self, name: str, **info) -> float:
        """Visit site ``name``; returns total injected delay seconds.

        Matching rules fire in declaration order, decrement their
        ``remaining`` budget, and are recorded in ``fired``. A ``kill``
        raises after recording (so post-mortem inspection sees it)."""
        delay = 0.0
        for rule in self.rules:
            if not rule.matches(name, info):
                continue
            rule.remaining -= 1
            self.fired.append((rule.action, name, dict(info)))
            if rule.action == "kill":
                raise Preemption(name, info)
            delay += rule.seconds
            if self.sleeper is not None:
                self.sleeper(rule.seconds)
        return delay

    def __repr__(self) -> str:
        live = sum(1 for r in self.rules if r.remaining > 0)
        return (f"FaultPlan({len(self.rules)} rules, {live} armed, "
                f"{len(self.fired)} fired)")
