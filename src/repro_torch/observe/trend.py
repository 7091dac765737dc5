"""Perf trajectory: load ``BENCH_*.json`` runs, compare against baselines.

Port of ``repro.observe.trend``, stdlib only (the port imports nothing of
``repro``; the comparison must run on any box before, or without, the
heavyweight dependencies). A benchmark run persists one
``BENCH_<name>.json`` per bench (wall clock, peak bytes, backend, device
kind, output lines, optional histogram metrics). This module turns a
directory of those records into a *trajectory* and a *gate*:

* :func:`load_dir` — ``{bench_name: record}`` for every BENCH file in a
  directory (schema versions 1 and 2);
* :func:`compare` / :func:`compare_dirs` — current run vs a committed
  baseline, flagging wall-clock and peak-bytes regressions beyond a
  noise band;
* :func:`format_report` — the human-readable report, failures first.

On the port's side a record's ``device_kind`` is the CUDA device's name
(``torch.cuda.get_device_name``), or ``cpu``.

Noise policy: wall clocks are machine- and load-dependent, so a
regression needs BOTH a relative excess (``wall_rtol``, default 1.0 =
2x the baseline) and an absolute excess (``wall_floor_s``) — a 30 ms
quick bench jittering to 70 ms is noise, a 30 s bench hitting 70 s is
not. When the current record's backend/device differs from the
baseline's, timing comparisons are demoted to warnings (wall clocks
across hardware are not comparable); structural fields (rows present,
bench still emitted) are always enforced. A bench present in the
baseline but missing from the current run is a failure — a perf trail
that silently goes dark is how trajectories become empty again.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

__all__ = ["load_bench", "load_dir", "Finding", "compare", "compare_dirs",
           "format_report", "WALL_RTOL", "WALL_FLOOR_S", "BYTES_RTOL",
           "BYTES_FLOOR"]

#: default noise bands (see module docstring); the gate CLI overrides
WALL_RTOL = 1.0          # fail past (1 + rtol) x baseline == 2x
WALL_FLOOR_S = 0.25      # ... and at least this much absolute excess
BYTES_RTOL = 0.25        # peak bytes are deterministic-ish: tighter band
BYTES_FLOOR = 1 << 20    # 1 MiB absolute slack


def load_bench(path: str | os.PathLike) -> dict:
    """Load one BENCH_*.json record (schema 1 or 2)."""
    with open(path) as f:
        rec = json.load(f)
    ver = rec.get("schema_version")
    if ver not in (1, 2):
        raise ValueError(f"{path}: unknown BENCH schema_version {ver!r}")
    return rec


def load_dir(directory: str | os.PathLike) -> dict[str, dict]:
    """All ``BENCH_<name>.json`` records in ``directory``, by bench name."""
    out: dict[str, dict] = {}
    for path in sorted(glob.glob(
            os.path.join(os.fspath(directory), "BENCH_*.json"))):
        rec = load_bench(path)
        out[rec["bench"]] = rec
    return out


@dataclasses.dataclass(frozen=True)
class Finding:
    """One comparison outcome. ``level`` is 'ok' | 'warn' | 'fail'."""

    bench: str
    field: str
    level: str
    baseline: float | None
    current: float | None
    detail: str

    @property
    def regressed(self) -> bool:
        return self.level == "fail"


def _ratio(cur: float, base: float) -> str:
    if base <= 0:
        return "n/a"
    return f"{cur / base:.2f}x"


def compare(current: dict, baseline: dict, *, wall_rtol: float = WALL_RTOL,
            wall_floor_s: float = WALL_FLOOR_S,
            bytes_rtol: float = BYTES_RTOL,
            bytes_floor: int = BYTES_FLOOR) -> list[Finding]:
    """Compare one current record against its baseline record."""
    name = current["bench"]
    out: list[Finding] = []
    same_hw = (current.get("backend") == baseline.get("backend")
               and current.get("device_kind") == baseline.get("device_kind"))

    def check(field: str, cur, base, rtol: float, floor: float,
              unit: str) -> None:
        if base is None or cur is None:
            return
        excess = cur - base * (1.0 + rtol)
        over = excess > 0 and (cur - base) > floor
        if not over:
            out.append(Finding(name, field, "ok", base, cur,
                               f"{cur:.4g}{unit} vs {base:.4g}{unit} "
                               f"({_ratio(cur, base)})"))
            return
        level = "fail" if same_hw else "warn"
        why = "" if same_hw else \
            (f" [hardware differs: {baseline.get('backend')}/"
             f"{baseline.get('device_kind')} -> {current.get('backend')}/"
             f"{current.get('device_kind')}; timing demoted to warning]")
        out.append(Finding(
            name, field, level, base, cur,
            f"{cur:.4g}{unit} vs baseline {base:.4g}{unit} "
            f"({_ratio(cur, base)}, band {1 + rtol:.2f}x + {floor:g}{unit})"
            f"{why}"))

    check("wall_clock_s", current.get("wall_clock_s"),
          baseline.get("wall_clock_s"), wall_rtol, wall_floor_s, "s")
    base_pb = baseline.get("peak_bytes") or 0
    cur_pb = current.get("peak_bytes") or 0
    if base_pb > 0 and cur_pb > 0:        # 0 = backend exposes no stats
        check("peak_bytes", float(cur_pb), float(base_pb), bytes_rtol,
              float(bytes_floor), "B")
    # histogram-derived latency percentiles (schema 2), same noise policy
    # as wall clock — they are wall clocks
    cur_m = current.get("metrics") or {}
    base_m = baseline.get("metrics") or {}
    for key in sorted(set(cur_m) & set(base_m)):
        if key.rsplit(".", 1)[-1] in ("p50", "p95", "p99", "mean"):
            check(f"metrics.{key}", cur_m[key], base_m[key], wall_rtol,
                  wall_floor_s, "s")
    if current.get("rows", 0) <= 0:
        out.append(Finding(name, "rows", "fail", baseline.get("rows"),
                           current.get("rows"),
                           "current run emitted no output lines"))
    return out


def compare_dirs(current_dir: str | os.PathLike,
                 baseline_dir: str | os.PathLike,
                 **kw) -> list[Finding]:
    """Compare every baseline bench against the current run's record."""
    current = load_dir(current_dir)
    baseline = load_dir(baseline_dir)
    if not baseline:
        raise FileNotFoundError(
            f"no BENCH_*.json baselines under {baseline_dir!r}")
    out: list[Finding] = []
    for name, base in sorted(baseline.items()):
        cur = current.get(name)
        if cur is None:
            out.append(Finding(name, "presence", "fail", None, None,
                               "bench in baseline but missing from the "
                               "current run (perf trail went dark)"))
            continue
        out.extend(compare(cur, base, **kw))
    for name in sorted(set(current) - set(baseline)):
        out.append(Finding(name, "presence", "warn", None, None,
                           "new bench with no committed baseline — add "
                           "one under benchmarks/baselines/"))
    return out


def format_report(findings: list[Finding]) -> str:
    """Human-readable gate report, failures first."""
    order = {"fail": 0, "warn": 1, "ok": 2}
    lines = [f"bench gate: {sum(f.regressed for f in findings)} "
             f"regression(s) in {len(findings)} comparison(s)"]
    for f in sorted(findings, key=lambda f: (order[f.level], f.bench,
                                             f.field)):
        lines.append(f"  [{f.level.upper():4s}] {f.bench}.{f.field}: "
                     f"{f.detail}")
    return "\n".join(lines)
