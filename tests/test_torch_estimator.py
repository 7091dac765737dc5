"""repro_torch.api (spec, registry, report, estimator) and data.synthetic
against the reference's behavior."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ProblemSpec as JProblem
from repro.api import registry as jreg
from repro.core import sodm as jsodm
from repro.data import synthetic as jsyn
from repro_torch.api import FitReport, ODMEstimator, ProblemSpec
from repro_torch.api import registry as treg
from repro_torch.core import sodm as tsodm
from repro_torch.data import synthetic as tsyn


def _blobs(M=96, seed=0):
    ds = tsyn.make_blobs(tsyn.DatasetSpec("t", M * 5 // 4 + 8, 5, 0.5, 1.5),
                         seed=seed)
    return ds.x_train[:M], ds.y_train[:M], ds.x_test, ds.y_test


def test_fit_then_score_on_cpu_default_engine():
    x, y, xt, yt = _blobs()
    est = ODMEstimator(ProblemSpec.create("rbf", gamma=1.0, lam=10.0),
                       cfg=tsodm.SODMConfig(levels=2), device="cpu")
    model, report = est.fit(x, y)
    assert isinstance(report, FitReport)
    assert report.route == "sodm" and report.engine == "scalar"
    assert model.device.type == "cpu" and model.n_sv == report.n_sv > 0
    assert est.score(xt, yt) > 0.8
    f = est.decision_function(xt)
    assert f.shape == (xt.shape[0],) and bool(torch.isfinite(f).all())
    torch.testing.assert_close(est.predict(xt), torch.sign(f))
    assert "route=sodm" in report.summary()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ODMEstimator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ODMEstimator(device="cuda")


def test_unported_routes_raise_with_roadmap_item():
    """Every route of the reference is registered; what is not ported yet
    (profiling) raises naming its ROADMAP item. A ShardedSource trains
    the dsvrg and cascade routes out of core; an array without labels
    raises."""
    from repro_torch.data import streaming as tds
    with pytest.raises(ValueError, match="unknown route"):
        ODMEstimator(route="nope", device="cpu")
    x, y, _, _ = _blobs()
    for route in ("dsvrg", "cascade"):
        kernel = "linear" if route == "dsvrg" else "rbf"
        est = ODMEstimator(ProblemSpec.create(kernel), device="cpu",
                           route=route)
        model, rep = est.fit(tds.ArraySource(x.numpy(), y.numpy(), 40))
        assert rep.route == route and rep.n_train == x.shape[0]
        assert model.device.type == "cpu"
        with pytest.raises(ValueError, match="labels"):
            est.fit(x)                     # an array, not a source
    # resume/faults are ported on the sodm and dsvrg routes; every other
    # route raises the reference's ValueError naming the seam
    for route in ("cascade", "dip", "dc", "svrg", "csvrg"):
        kernel = "linear" if route in ("svrg", "csvrg") else "rbf"
        est = ODMEstimator(ProblemSpec.create(kernel), device="cpu",
                           route=route)
        with pytest.raises(ValueError, match=f"route '{route}' has no "
                                             f"faults seam"):
            est.fit(x, y, faults=object())
        with pytest.raises(ValueError, match="has no resume seam"):
            est.fit(x, y, resume="/nonexistent")
    with pytest.raises(NotImplementedError, match="A15"):
        ODMEstimator(device="cpu").fit(x, y, profile_dir="/nonexistent")


@pytest.mark.parametrize("kernel", ["rbf", "linear", "poly"])
@pytest.mark.parametrize("M", [96, 200_000])
@pytest.mark.parametrize("engine", [None, "scalar", "pallas", "dsvrg"])
def test_resolve_policy_matches_reference(kernel, M, engine):
    """Same engine × kernel × size rules: the reference's answer is the
    port's, and a problem the reference refuses the port refuses."""
    jcfg = jsodm.SODMConfig(engine=engine)
    tcfg = tsodm.SODMConfig(engine=engine)
    try:
        want = jreg.resolve(JProblem.create(kernel), M, cfg=jcfg).name
    except ValueError:
        want = None
    if want is None:
        with pytest.raises(ValueError):
            treg.resolve(ProblemSpec.create(kernel), M, cfg=tcfg)
    else:
        assert treg.resolve(ProblemSpec.create(kernel), M,
                            cfg=tcfg).name == want
    for route in ("cascade", "dip", "dc", "svrg", "csvrg"):
        try:
            want = jreg.resolve(JProblem.create(kernel), M, route=route,
                                cfg=jcfg).name
        except ValueError:
            with pytest.raises(ValueError):
                treg.resolve(ProblemSpec.create(kernel), M, route=route,
                             cfg=tcfg)
        else:
            assert treg.resolve(ProblemSpec.create(kernel), M, route=route,
                                cfg=tcfg).name == want


def test_pin_level_engine_and_registry_errors():
    cfg = treg._pin_level_engine(tsodm.SODMConfig(), "sodm")
    assert cfg.engine == "scalar"
    with pytest.raises(ValueError, match="contradictory"):
        treg._pin_level_engine(tsodm.SODMConfig(engine="dsvrg"), "sodm")
    with pytest.raises(ValueError, match="contradictory"):
        treg.resolve(ProblemSpec(), 10, route="sodm",
                     cfg=tsodm.SODMConfig(engine="dsvrg"))
    with pytest.raises(ValueError, match="already registered"):
        treg.register(treg.get("sodm"))
    assert treg.routes() == ("cascade", "csvrg", "dc", "dip", "dsvrg",
                             "sodm", "svrg")
    assert treg.get("sodm").capabilities().startswith("sodm:")
    assert "kernels {linear}" in treg.get("dsvrg").capabilities()
    assert treg.dsvrg_partition_count(96, 8) == 8
    assert treg.dsvrg_partition_count(90, 8) == 6
    assert treg.dsvrg_partition_count(90, 8) == \
        jreg.dsvrg_partition_count(90, 8)
    with pytest.raises(ValueError, match="partition count"):
        treg.dsvrg_partition_count(7, 4, n_dev=2)


@pytest.mark.parametrize("kw", [dict(kernel="sigmoid"),
                                dict(kernel="rbf", gamma=0.0),
                                dict(kernel="poly", degree=0),
                                dict(lam=0.0), dict(ups=-1.0),
                                dict(theta=1.0)])
def test_problem_spec_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        JProblem.create(**kw)
    with pytest.raises(ValueError):
        ProblemSpec.create(**kw)


def test_data_validation():
    p = ProblemSpec()
    x, y = p.validate(np.zeros((4, 2)), np.array([1, -1, 1, -1]))
    assert x.dtype == torch.float32 and y.dtype == torch.float32
    for bad in ((np.zeros(4), np.ones(4)), (np.zeros((4, 2)), np.ones(3)),
                (np.zeros((4, 2)), np.array([1, 0, 1, -1])),
                (np.zeros((0, 2)), np.zeros(0))):
        with pytest.raises(ValueError):
            p.validate(*bad)


def test_synthetic_specs_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in
            tsyn.PAPER_DATASETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jsyn.PAPER_DATASETS.items()}
    t = tsyn.load("phishing", scale=0.02)
    j = jsyn.load("phishing", scale=0.02)
    for a, b in zip(t[:4], j[:4]):
        assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("name", ["phishing", "ijcnn1", "svmguide1"])
def test_synthetic_data_is_seeded_scaled_and_balanced(name):
    t = tsyn.load(name, scale=0.02)
    assert float(t.x_train.min()) >= 0.0 and float(t.x_train.max()) <= 1.0
    assert set(torch.unique(t.y_train).tolist()) <= {-1.0, 1.0}
    bal = float((t.y_train > 0).float().mean())
    assert abs(bal - tsyn.PAPER_DATASETS[name].balance) < 0.08
    torch.testing.assert_close(tsyn.load(name, scale=0.02).x_test, t.x_test)
    with pytest.raises(KeyError):
        tsyn.load("nope")
