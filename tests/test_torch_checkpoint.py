"""repro_torch.distributed.checkpoint and the artifact's save/load against
repro.distributed.checkpoint / repro.serve.model.

Both packages write the same layout (step_<n>/arrays.npz + manifest.json,
format 1), so a step or a FittedODM saved by one loads in the other
exactly: the arrays bit for bit, the manifest fields equal.
"""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf
from repro.distributed.checkpoint import CheckpointManager as JManager
from repro.serve import model as jmodel
from repro_torch.api import ODMEstimator
from repro_torch.core import kernel_fns as tkf
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.serve import model as tmodel


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(5).astype(np.float32),
            "nested": {"a": rng.integers(0, 9, (2, 3)).astype(np.int32),
                       "b": [rng.integers(0, 200, 4).astype(np.uint8),
                             rng.random((1, 2)).astype(np.float32)]}}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return torch.from_numpy(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: np.asarray(tree)}


def test_port_step_loads_in_the_reference(tmp_path):
    tree = _tree()
    path = CheckpointManager(str(tmp_path)).save(
        7, _as_torch(tree), {"step": 7, "note": "port"})
    assert os.path.basename(path) == "step_0000000007"
    jm = JManager(str(tmp_path))
    assert jm.metadata()["metadata"] == {"step": 7, "note": "port"}
    assert jm.metadata()["format"] == 1
    back = jm.restore(tree)
    for k, v in _leaves(tree).items():
        got = _leaves(back)[k]
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)


def test_reference_step_loads_in_the_port(tmp_path):
    tree = _tree(1)
    JManager(str(tmp_path)).save(3, tree, {"kind": "ref"})
    tm = CheckpointManager(str(tmp_path))
    assert tm.latest_step() == 3
    assert tm.metadata()["metadata"] == {"kind": "ref"}
    back = tm.restore(tree)
    for k, v in _leaves(tree).items():
        got = _leaves(back)[k]
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)


def test_bfloat16_is_stored_as_its_view_both_ways(tmp_path):
    vals = np.array([1.5, -2.25, 3e-3], np.float32)
    CheckpointManager(str(tmp_path / "p")).save(
        0, {"h": torch.tensor(vals).to(torch.bfloat16)})
    man = json.load(open(tmp_path / "p" / "step_0000000000" /
                         "manifest.json"))
    assert man["leaves"]["h"] == {"shape": [3], "dtype": "bfloat16"}
    j = JManager(str(tmp_path / "p")).restore(
        {"h": jnp.zeros(3, jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(j["h"], np.float32),
                                  vals.astype(ml_dtypes.bfloat16)
                                  .astype(np.float32))
    JManager(str(tmp_path / "r")).save(
        0, {"h": jnp.asarray(vals, jnp.bfloat16)})
    t = CheckpointManager(str(tmp_path / "r")).restore({"h": None})
    assert t["h"].dtype == torch.bfloat16
    assert torch.equal(t["h"], torch.tensor(vals).to(torch.bfloat16))


def test_retention_atomicity_and_unported_seams(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "step_0000000009.tmp.12345")     # dead writer
    for s in range(4):
        m.save(s, {"x": torch.full((2,), float(s))})
    assert m.all_steps() == [2, 3]
    assert not any(".tmp." in n for n in os.listdir(tmp_path))
    assert torch.equal(m.restore({"x": None}, step=2)["x"],
                       torch.full((2,), 2.0))
    with pytest.raises(KeyError, match="missing leaf"):
        m.restore({"y": None})
    # save_async and the fault seam are ported (tests/test_torch_resume.py
    # holds them to the reference); the async write commits like save
    m.save_async(5, {"x": torch.zeros(1)})
    m.wait()
    assert m.all_steps() == [3, 5]
    assert CheckpointManager(str(tmp_path), faults=object()).faults \
        is not None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"x": None})


@pytest.mark.parametrize("form", ["exact", "linear"])
def test_fitted_odm_crosses_between_the_packages(form, tmp_path):
    rng = np.random.default_rng(2)
    x_sv = rng.random((9, 4)).astype(np.float32)
    coef = rng.standard_normal(9).astype(np.float32)
    w = rng.standard_normal(4).astype(np.float32)
    xt = rng.random((6, 4)).astype(np.float32)
    name = "rbf" if form == "exact" else "linear"
    arrays = dict(x_sv=x_sv, coef=coef) if form == "exact" else dict(w=w)
    jm = jmodel.FittedODM(spec=jkf.KernelSpec(name, 0.4), n_train=40,
                          compression=form, gap=0.125,
                          **{k: jnp.asarray(v) for k, v in arrays.items()})
    tm = tmodel.FittedODM(spec=tkf.KernelSpec(name, 0.4), n_train=40,
                          compression=form, gap=0.125,
                          **{k: torch.tensor(v) for k, v in arrays.items()})
    jm.save(str(tmp_path / "j"))
    tm.save(str(tmp_path / "t"))
    from_j = tmodel.load_model(str(tmp_path / "j"), device="cpu")
    from_t = jmodel.load_model(str(tmp_path / "t"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(from_j, k).numpy(), v)
        np.testing.assert_array_equal(np.asarray(getattr(from_t, k)), v)
    for m in (from_j, from_t):
        assert (m.n_train, m.compression, m.gap) == (40, form, 0.125)
        assert m.spec.name == name and m.spec.gamma == 0.4
    assert torch.equal(from_j.decision_function(xt),
                       tm.decision_function(xt))
    est = ODMEstimator.load(str(tmp_path / "j"), device="cpu")
    assert est.problem.kernel == tkf.KernelSpec(name, 0.4)
    assert torch.equal(est.predict(xt), tm.predict(xt))


def test_load_refuses_other_checkpoints(tmp_path):
    CheckpointManager(str(tmp_path)).save(0, {"x": torch.zeros(1)},
                                          {"kind": "other"})
    with pytest.raises(ValueError, match="FittedODM"):
        tmodel.load_model(str(tmp_path), device="cpu")
