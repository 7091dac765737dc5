"""repro_torch.observe.profiler (port of repro.observe.profiler):
``profile_ctx(None)`` is a no-op in both packages; a CPU
``fit(profile_dir=)`` on every route writes a Chrome trace that loads as
JSON and has events, and equals the unprofiled fit bit for bit; a
profiler that cannot start warns and the fit goes on; the trace reader
groups CUDA kernel events by launch counter."""
import json
import os

import pytest
import torch

from repro.observe import profiler as jprof
from repro_torch.analysis import invariants as inv
from repro_torch.observe import profiler as tprof

ROUTES = ("sodm", "dsvrg", "cascade", "dip", "dc", "svrg", "csvrg")


def test_none_is_a_noop_in_both_packages(tmp_path):
    for mod in (jprof, tprof):
        with mod.profile_ctx(None):
            pass
    with tprof.profile_ctx(None, torch.device("cpu")):
        pass
    assert os.listdir(tmp_path) == []


def _model_tensors(model):
    return [t for t in (model.w, model.x_sv, model.coef) if t is not None]


@pytest.mark.parametrize("route", ROUTES)
def test_profiled_fit_writes_trace_and_equals_bare_fit(tmp_path, route):
    x, y = inv._toy_data(32, 4)
    bare, _ = inv._estimator(route, "cpu").fit(x, y, 0)
    prof, rep = inv._estimator(route, "cpu").fit(
        x, y, 0, profile_dir=tmp_path / "p")
    with open(tmp_path / "p" / tprof.FILENAME) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert rep.route == route
    for a, b in zip(_model_tensors(bare), _model_tensors(prof),
                    strict=True):
        assert torch.equal(a, b)


def test_profiler_that_cannot_start_warns(tmp_path, monkeypatch):
    import torch.profiler as tp

    def refuse(self):
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(tp.profile, "__enter__", refuse)
    x, y = inv._toy_data(32, 4)
    with pytest.warns(RuntimeWarning, match="continuing unprofiled"):
        model, _ = inv._estimator("dsvrg", "cpu").fit(
            x, y, 0, profile_dir=tmp_path / "p")
    assert not os.path.exists(tmp_path / "p" / tprof.FILENAME)
    bare, _ = inv._estimator("dsvrg", "cpu").fit(x, y, 0)
    assert torch.equal(model.w, bare.w)


def test_kernel_summary_groups_by_counter():
    ev = [
        {"ph": "X", "cat": "kernel", "dur": 10.0,
         "name": "void (anonymous namespace)::gram_matvec_kernel<1, true>"
                 "(float const*, Shape, float)"},
        {"ph": "X", "cat": "kernel", "dur": 2.0,
         "name": "(anonymous namespace)::reduce_sym(float const*, float*)"},
        {"ph": "X", "cat": "kernel", "dur": 5.0,
         "name": "void (anonymous namespace)::gram_kernel<1, true, true>"
                 "(float const*)"},
        {"ph": "X", "cat": "kernel", "dur": 7.0,
         "name": "void (anonymous namespace)::cd_sweep_kernel<8, true>()"},
        {"ph": "X", "cat": "kernel", "dur": 3.0, "name": "at::native::add"},
        {"ph": "X", "cat": "cpu_op", "dur": 99.0, "name": "gram_kernel"},
    ]
    got = tprof.kernel_summary({"traceEvents": ev})
    assert got["gram_matvec"]["count"] == 2
    assert got["gram_matvec"]["us"] == 12.0
    assert got["gram"]["count"] == 1 and got["gram"]["us"] == 5.0
    assert got["cd_block_sweep"]["symbols"] == {"cd_sweep_kernel": 1}
    assert set(got) == {"gram_matvec", "gram", "cd_block_sweep"}
    assert tprof.busy_share(ev, 1e-4) == pytest.approx(0.27)


def test_every_launch_counter_has_its_symbols():
    """Every wrapper that counts launches (but score_tiles, which
    launches K2's kernels) names the CUDA kernels a trace shows for it."""
    import repro_torch.core.dual_cd  # noqa: F401  (K4's counter)
    import repro_torch.kernels.ops  # noqa: F401  (every other wrapper)
    counted = {n[len("launch."):] for n in inv.counters()
               if n.startswith("launch.")}
    assert counted - {"score_tiles"} == set(tprof.KERNEL_SYMBOLS)
