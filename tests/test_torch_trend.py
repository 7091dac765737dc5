"""repro_torch.observe.trend against repro.observe.trend: the committed
baselines under benchmarks/baselines/, and copies perturbed the ways the
reference's TestTrendGate covers (a 10x slowdown, jitter, another
device, a missing bench, a new bench, latency percentiles, empty rows, a
bad schema), give equal Finding tuples and equal format_report text
through both packages."""
import dataclasses
import json
import os
import shutil

import pytest

from repro.observe import trend as jtrend
from repro_torch.observe import trend as ttrend

BASELINES = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                         "baselines")


def _both(fn_name, *args, **kw):
    """(reference result, port result) of ``trend.<fn_name>``; an
    exception from either is returned as its (type name, message)."""
    out = []
    for mod in (jtrend, ttrend):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except Exception as e:          # compared, not swallowed
            out.append((type(e).__name__, str(e)))
    return out


def _tuples(findings):
    if isinstance(findings, tuple):
        return findings
    return [dataclasses.astuple(f) for f in findings]


def _assert_same(cur, base, **kw):
    j, t = _both("compare_dirs", cur, base, **kw)
    assert _tuples(t) == _tuples(j)
    if not isinstance(j, tuple):
        assert ttrend.format_report(t) == jtrend.format_report(j)
        assert [f.regressed for f in t] == [f.regressed for f in j]
    return t


def _copy(tmp_path, name="cur"):
    d = tmp_path / name
    shutil.copytree(BASELINES, d)
    return d


def _edit(d, bench, **changes):
    path = d / f"BENCH_{bench}.json"
    rec = json.loads(path.read_text())
    for k, v in changes.items():
        if v is None:
            rec.pop(k, None)
        else:
            rec[k] = v
    path.write_text(json.dumps(rec))
    return rec


def test_committed_baselines_self_compare():
    t = _assert_same(BASELINES, BASELINES)
    assert t and not any(f.regressed for f in t)


def test_load_dir_equal():
    j, t = _both("load_dir", BASELINES)
    assert t == j and len(t) == len(os.listdir(BASELINES))


@pytest.mark.parametrize("case", [
    "slowdown_10x", "jitter", "other_device", "missing_bench", "new_bench",
    "percentiles", "empty_rows", "bad_schema", "peak_bytes", "no_baselines",
])
def test_perturbed_runs_agree(tmp_path, case):
    base = _copy(tmp_path, "base")
    cur = _copy(tmp_path, "cur")
    rec = json.loads((cur / "BENCH_serve.json").read_text())
    wall = float(rec["wall_clock_s"])
    if case == "slowdown_10x":
        _edit(cur, "serve", wall_clock_s=10 * wall + 1.0)
    elif case == "jitter":
        _edit(cur, "serve", wall_clock_s=wall * 1.3)
    elif case == "other_device":
        _edit(cur, "serve", wall_clock_s=10 * wall + 1.0, backend="gpu",
              device_kind="NVIDIA H100 80GB HBM3")
    elif case == "missing_bench":
        os.remove(cur / "BENCH_serve.json")
    elif case == "new_bench":
        r = _edit(cur, "serve")
        r["bench"] = "fresh"
        (cur / "BENCH_fresh.json").write_text(json.dumps(r))
    elif case == "percentiles":
        metrics = dict(rec.get("metrics") or {})
        metrics["serve.request.latency_s.p99"] = 5.0
        metrics["serve.request.latency_s.p50"] = 0.001
        _edit(cur, "serve", metrics=metrics, schema_version=2)
        bm = dict(metrics)
        bm["serve.request.latency_s.p99"] = 0.01
        _edit(base, "serve", metrics=bm, schema_version=2)
    elif case == "empty_rows":
        _edit(cur, "serve", rows=0)
    elif case == "bad_schema":
        _edit(cur, "serve", schema_version=99)
    elif case == "peak_bytes":
        _edit(base, "serve", peak_bytes=1 << 24)
        _edit(cur, "serve", peak_bytes=3 << 24)
    elif case == "no_baselines":
        shutil.rmtree(base)
        os.makedirs(base)
    t = _assert_same(cur, base)
    if case in ("slowdown_10x", "missing_bench", "empty_rows",
                "percentiles", "peak_bytes"):
        assert any(f.regressed for f in t)
    if case in ("jitter", "other_device", "new_bench"):
        assert not any(f.regressed for f in t)


def test_port_gate_bands_equal_the_references():
    for name in ("WALL_RTOL", "WALL_FLOOR_S", "BYTES_RTOL", "BYTES_FLOOR"):
        assert getattr(ttrend, name) == getattr(jtrend, name)
    assert ttrend.__all__ == jtrend.__all__
