"""repro_torch.observe.tracker against repro.observe.tracker: the same
metric stream (0-d tensors beside jnp scalars of equal value) writes the
same bytes through both packages' JsonlTracker, each package's
read_jsonl reads the other's file (torn tail included), and the port's
backends keep the reference's lifecycle (TestTrackerBackends /
TestReadJsonlEdgeCases of tests/test_observe.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import observe as jobs
from repro_torch import observe as tobs


def _stream(pkg: str):
    """One metric stream; the reference's values as jnp / numpy scalars,
    the port's as 0-d tensors of the same dtype and value."""
    if pkg == "jax":
        f32, i32 = jnp.float32, jnp.int32
    else:
        def f32(v):
            return torch.tensor(v, dtype=torch.float32)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32)
    return [
        (0, {"level": 2, "kkt": f32(1e-3), "sweeps": i32(7),
             "route": "sodm", "fit_done": False, "gap": None}),
        (1, {"objective": f32(0.123456789), "rows_per_s": 1234.5,
             "eta": np.float64(0.25), "sv_count": 17}),
        (2, {"kkt": f32(3.5e-7), "wall_s": f32(12.0)}),
    ]


def test_jsonl_files_equal_byte_for_byte(tmp_path):
    for pkg, mod in (("jax", jobs), ("torch", tobs)):
        with mod.JsonlTracker(tmp_path / f"{pkg}.jsonl") as t:
            for step, m in _stream(pkg):
                t.log_metrics(step, m)
    assert (tmp_path / "jax.jsonl").read_bytes() == \
        (tmp_path / "torch.jsonl").read_bytes()


def test_in_memory_trackers_agree():
    j, t = jobs.InMemoryTracker(), tobs.InMemoryTracker()
    for step, m in _stream("jax"):
        j.log_metrics(step, m)
    for step, m in _stream("torch"):
        t.log_metrics(step, m)
    assert t.steps == j.steps
    assert t.series("kkt") == j.series("kkt")
    assert t.latest() == j.latest()
    assert all(type(v) is float for v in t.series("kkt"))


@pytest.mark.parametrize("writer,reader", [(jobs, tobs), (tobs, jobs)])
def test_read_jsonl_reads_the_other_package(tmp_path, writer, reader):
    path = tmp_path / "m.jsonl"
    with writer.JsonlTracker(path) as t:
        for step, m in _stream("jax" if writer is jobs else "torch"):
            t.log_metrics(step, m)
    with open(path, "a") as f:
        f.write('{"step": 99, "v": tor')    # killed mid-line
    assert reader.read_jsonl(path) == writer.read_jsonl(path)
    assert [r["step"] for r in reader.read_jsonl(path)] == [0, 1, 2]


def test_non_scalar_values_are_repr_not_crash():
    t = tobs.InMemoryTracker()
    t.log_metrics(0, {"vec": torch.ones(3)})
    assert isinstance(t.latest()["vec"], str)


class TestTrackerBackends:
    def test_runtime_protocol_conformance(self, tmp_path):
        backends = [tobs.InMemoryTracker(),
                    tobs.JsonlTracker(tmp_path / "t.jsonl"),
                    tobs.CompositeTracker([]), tobs.MetricsRegistry()]
        for b in backends:
            assert isinstance(b, tobs.Tracker), type(b).__name__

        class Nope:
            pass
        assert not isinstance(Nope(), tobs.Tracker)

    def test_jsonl_persistent_handle(self, tmp_path):
        path = tmp_path / "m.jsonl"
        t = tobs.JsonlTracker(path)
        assert t._file is None                 # lazy: no file until logged
        t.log_metrics(0, {"a": 1})
        f0 = t._file
        t.log_metrics(1, {"a": 2})
        assert t._file is f0                   # one handle across calls
        assert [r["a"] for r in tobs.read_jsonl(path)] == [1, 2]
        t.close()
        assert t._file is None
        t.log_metrics(2, {"a": 3})             # reopens
        t.close()
        assert len(tobs.read_jsonl(path)) == 3

    def test_jsonl_context_manager_closes(self, tmp_path):
        with tobs.JsonlTracker(tmp_path / "m.jsonl") as t:
            t.log_metrics(0, {"x": torch.tensor(1.0)})
            assert t._file is not None
        assert t._file is None

    def test_composite_fans_out(self, tmp_path):
        a, b = tobs.InMemoryTracker(), tobs.InMemoryTracker()
        tobs.CompositeTracker([a, b]).log_metrics(3, {"k": 1.5})
        assert a.steps == b.steps == [(3, {"k": 1.5})]


class TestReadJsonlEdgeCases:
    def test_empty_file(self, tmp_path):
        path = tmp_path / "e.jsonl"
        path.write_text("")
        assert tobs.read_jsonl(path) == []

    def test_only_torn_lines(self, tmp_path):
        path = tmp_path / "torn.jsonl"
        path.write_text('{"a": \n{"b"\nnot json at all\n')
        assert tobs.read_jsonl(path) == jobs.read_jsonl(path) == []

    def test_blank_lines_skipped(self, tmp_path):
        path = tmp_path / "b.jsonl"
        path.write_text('\n{"step": 0}\n\n{"step": 1}\n')
        assert [r["step"] for r in tobs.read_jsonl(path)] == [0, 1]

    def test_interleaved_writers(self, tmp_path):
        path = tmp_path / "shared.jsonl"
        a, b = tobs.JsonlTracker(path), tobs.JsonlTracker(path)
        for i in range(5):
            a.log_metrics(i, {"w": "a"})
            b.log_metrics(i, {"w": "b"})
        a.close()
        b.close()
        recs = tobs.read_jsonl(path)
        assert len(recs) == 10 and {r["w"] for r in recs} == {"a", "b"}


def test_observe_all_is_the_references():
    assert tobs.__all__ == jobs.__all__
