"""Straggler mitigation for the SODM partition scheduler.

A copy of the pure-Python ``repro.distributed.straggler`` (the port
imports nothing of ``repro``), with the port's spans and fault sites.

The SODM level solve is embarrassingly parallel and *idempotent*: each
partition solve is a pure function of (X_k, y_k, alpha_init). On a real
cluster some workers straggle (bad host, thermal throttling, preemption),
so the scheduler:

  1. dispatches all partition solves to the worker pool;
  2. watches completion; once ``spec_quantile`` of tasks finished, starts a
     deadline = ``spec_factor`` x median completion time;
  3. past the deadline, re-dispatches still-running tasks to idle workers
     (speculative duplicates); first completion wins, losers are ignored
     (pure function => identical results, no coordination needed).

For a synchronous data-parallel train loop stragglers are a non-issue by
construction (a collective gates every step), so mitigation there lives
at the checkpoint/elastic level.

On this single-node container the pool is threads and "stragglers" are
simulated in tests by sleeping tasks; the scheduler logic (quantile
tracking, deadline, duplicate dispatch, first-wins) is exactly what a
multi-host dispatcher would run.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time
from typing import Any, Callable, Sequence

from repro_torch.observe.spans import span as _span


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    max_workers: int = 8
    spec_quantile: float = 0.75    # fraction done before arming the deadline
    spec_factor: float = 2.0       # deadline = factor x median duration
    max_duplicates: int = 2        # per task
    poll_s: float = 0.005


class SpeculativeScheduler:
    def __init__(self, cfg: SpecConfig = SpecConfig()):
        self.cfg = cfg

    def run(self, tasks: Sequence[Callable[[], Any]],
            faults=None) -> list[Any]:
        """Execute all tasks; returns results in task order.

        Each task may be re-submitted up to max_duplicates extra times once
        the speculation deadline passes; the first completed attempt's
        result is kept.

        ``faults`` (a :class:`repro_torch.distributed.faults.FaultPlan`) fires
        the ``"cascade.partition"`` site at the start of every attempt:
        a ``delay`` rule makes that partition straggle (speculation under
        test), a ``kill`` rule fails the attempt — idempotent tasks mean
        the scheduler just re-dispatches it, which is the worker-loss
        recovery path this instrument exists to prove.
        """
        n = len(tasks)
        results: list[Any] = [None] * n
        done = [False] * n
        attempts = [0] * n
        durations: list[float] = []
        lock = threading.Lock()

        # NOT a `with` block: first-completion-wins means losers may still
        # be running when all results are in; shutdown(wait=False) lets us
        # return immediately instead of joining abandoned duplicates.
        pool = cf.ThreadPoolExecutor(max_workers=self.cfg.max_workers)
        try:
            futures: dict[cf.Future, int] = {}

            def submit(i):
                t0 = time.monotonic()
                attempts[i] += 1
                att = attempts[i]

                def wrapped():
                    with _span("straggler.attempt", partition=i,
                               attempt=att):
                        if faults is not None:
                            faults.site("cascade.partition", partition=i,
                                        attempt=att)
                        out = tasks[i]()
                    return out, time.monotonic() - t0

                futures[pool.submit(wrapped)] = i

            for i in range(n):
                submit(i)

            armed_at = None
            while True:
                with lock:
                    if all(done):
                        break
                finished, _ = cf.wait(list(futures),
                                      timeout=self.cfg.poll_s,
                                      return_when=cf.FIRST_COMPLETED)
                for f in finished:
                    i = futures.pop(f)
                    try:
                        out, dt = f.result()
                    except Exception:
                        # failed attempt: re-dispatch unconditionally
                        if not done[i]:
                            submit(i)
                        continue
                    with lock:
                        if not done[i]:
                            results[i] = out
                            done[i] = True
                            durations.append(dt)
                # arm speculation once the quantile completed
                frac = sum(done) / n
                if armed_at is None and frac >= self.cfg.spec_quantile \
                        and durations:
                    med = sorted(durations)[len(durations) // 2]
                    armed_at = time.monotonic() + \
                        max(self.cfg.spec_factor * med, 0.01)
                if armed_at is not None and time.monotonic() > armed_at:
                    for i in range(n):
                        if not done[i] and attempts[i] <= self.cfg.max_duplicates:
                            submit(i)
                    med = sorted(durations)[len(durations) // 2] \
                        if durations else 0.05
                    armed_at = time.monotonic() + \
                        max(self.cfg.spec_factor * med, 0.01)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        return results
