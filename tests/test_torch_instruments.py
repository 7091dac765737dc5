"""repro_torch.observe.instruments against repro.observe.instruments on the
same seeded observations: the nearest-rank percentile, the histogram and
counter/gauge snapshots, and the registry as a draining tracker."""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.observe import instruments as ref
from repro_torch.observe import instruments as port

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _values(seed: int, n: int) -> list[float]:
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.lognormal(-6.0, 2.0, n)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 40, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_percentile_equals_reference(seed, n):
    vals = _values(seed, n)
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert port.percentile(vals, q) == ref.percentile(vals, q)
        assert port.percentile(sorted(vals), q) == \
            ref.percentile(sorted(vals), q)


def test_percentile_rejects_what_the_reference_rejects():
    for args in (([], 50), ([1.0], -1), ([1.0], 101)):
        with pytest.raises(ValueError):
            ref.percentile(*args)
        with pytest.raises(ValueError):
            port.percentile(*args)


@pytest.mark.parametrize("max_samples,n", [(65536, 500), (64, 1000)],
                         ids=["exact", "downsampled"])
def test_histogram_snapshot_equals_reference(max_samples, n):
    vals = _values(3, n)
    hr = ref.Histogram("lat", max_samples=max_samples)
    hp = port.Histogram("lat", max_samples=max_samples)
    for v in vals:
        hr.observe(v)
        hp.observe(v)
    assert hp.snapshot() == hr.snapshot()
    assert hp.counts == hr.counts and hp.samples == hr.samples
    assert port.Histogram("e").snapshot() == ref.Histogram("e").snapshot()


def test_registry_snapshot_and_drain_equal_reference():
    vals = _values(4, 64)
    regs = (ref.MetricsRegistry(), port.MetricsRegistry())
    for reg in regs:
        reg.counter("serve.requests").inc(3)
        reg.counter("serve.requests").inc()
        for v in vals[:5]:
            reg.gauge("serve.queue_depth").set(v)
        for i, v in enumerate(vals):
            reg.log_metrics(i, {"wall_s": v, "route": "sodm",
                                "fit_done": True, "sv_count": i})
    snap_ref, snap_port = (r.snapshot() for r in regs)
    assert snap_port == snap_ref

    class Sink:
        def __init__(self):
            self.rows = []

        def log_metrics(self, step, metrics):
            self.rows.append((step, dict(metrics)))

    sinks = (Sink(), Sink())
    for reg, sink in zip(regs, sinks):
        reg.drain(sink, step=7)
    assert sinks[1].rows == sinks[0].rows
    with pytest.raises(TypeError, match="already exists"):
        regs[1].histogram("serve.requests")


def test_snapshot_folds_in_the_port_counters():
    """One process-wide counter store: each wrapper's ``launches`` and the
    level solves are counters of ``repro_torch.analysis.invariants``, and
    the snapshot reads that store, whose bumps it sees."""
    from repro_torch.analysis import invariants as inv
    from repro_torch.core import dual_cd, sodm
    from repro_torch.kernels import gram, odm_grad, score
    for name, c in (("launch.score_tiles", score.score_tiles.launches),
                    ("launch.gram_matvec", gram.gram_matvec.launches),
                    ("launch.odm_svrg_epoch",
                     odm_grad.odm_svrg_epoch.launches),
                    ("launch.cd_exact", dual_cd.solve.launches),
                    ("sodm.level_solve", sodm._LEVEL_SOLVES)):
        assert inv.counter(name) is c
        before = port.MetricsRegistry().snapshot(include_counters=True)
        c.bump(3)
        snap = port.MetricsRegistry().snapshot(include_counters=True)
        c.bump(-3)
        assert snap[f"counter.{name}.count"] == \
            before[f"counter.{name}.count"] + 3 == c.count + 3
    assert sodm.level_solve_count() == sodm._LEVEL_SOLVES.count


def test_instruments_import_no_higher_layer():
    """The observe layer reads the neutral counter store and knows nothing
    of the kernels, the solvers or the server."""
    code = ("import sys, repro_torch.observe.instruments; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": SRC}).stdout
    assert eval(out) == ["repro_torch.analysis",
                         "repro_torch.analysis.invariants",
                         "repro_torch.observe",
                         "repro_torch.observe.instruments",
                         "repro_torch.observe.spans"]
