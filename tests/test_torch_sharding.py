"""repro_torch.sharding against repro.sharding: rule resolution, the
fallbacks and the tree helpers, on duck-typed meshes (both packages read
only ``mesh.shape``, so an object whose ``shape`` maps axis names to
sizes drives both without a device per rank), then the cases of
``tests/test_sharding.py`` as cases of one test. No process group."""
import itertools

import numpy as np
import pytest

from repro import sharding as jshd
from repro_torch import sharding as tshd


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = [dict(data=4, model=2), dict(data=16, model=16),
          dict(pod=2, data=16, model=16), dict(data=8), dict(data=1,
                                                             model=1)]
NAMES = [None, "batch", "embed", "mlp", "heads", "kv_heads", "vocab",
         "experts", "kv_seq", "seq", "layers", "head_dim", "unknown"]
DIMS = [1, 6, 9, 16, 64, 256]


def _jspec(axes, shape, mesh, rules=None):
    jr = None if rules is None else jshd.ShardingRules().replace(**rules)
    return tuple(jshd.logical_to_spec(axes, shape, mesh, jr))


def _tspec(axes, shape, mesh, rules=None):
    tr = None if rules is None else tshd.ShardingRules().replace(**rules)
    return tuple(tshd.logical_to_spec(axes, shape, mesh, tr))


def test_default_rules_are_the_reference():
    assert tshd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert tshd.ShardingRules().rules == jshd.ShardingRules().rules


@pytest.mark.parametrize("sizes", MESHES,
                         ids=lambda m: "x".join(f"{k}{v}" for k, v in
                                                m.items()))
def test_logical_to_spec_matches_reference(sizes):
    """Every pair of logical names over every pair of dims from a grid
    that divides some axes and not others, and three-dim cases where an
    axis is claimed twice."""
    mesh = FakeMesh(**sizes)
    rng = np.random.default_rng(len(sizes))
    for a, b in itertools.product(NAMES, NAMES):
        for da, db in itertools.product(DIMS, DIMS):
            axes, shape = (a, b), (da, db)
            assert _tspec(axes, shape, mesh) == _jspec(axes, shape, mesh), \
                (axes, shape)
    for _ in range(200):
        axes = tuple(rng.choice(np.array(NAMES, dtype=object), 3))
        shape = tuple(int(d) for d in rng.choice(DIMS, 3))
        assert _tspec(axes, shape, mesh) == _jspec(axes, shape, mesh)


@pytest.mark.parametrize("rules", [dict(embed=None, mlp="data"),
                                   dict(batch=("pod", "data", "model")),
                                   dict(kv_seq="data", heads=None),
                                   dict(batch="model", vocab=("data",))])
def test_rule_overrides_match_reference(rules):
    for sizes in MESHES:
        mesh = FakeMesh(**sizes)
        for axes in itertools.product(NAMES[:9], repeat=2):
            for shape in ((512, 128), (9, 64), (256, 6)):
                assert _tspec(axes, shape, mesh, rules) == \
                    _jspec(axes, shape, mesh, rules)


def test_tree_specs_match_reference():
    axes = {"a": ("embed", "mlp"), "b": {"c": ("vocab",), "d": ()},
            "e": [("batch", None), ("heads", "head_dim")]}
    shapes = {"a": (64, 256), "b": {"c": (49152,), "d": ()},
              "e": [(256, 10), (9, 64)]}
    for sizes in MESHES:
        mesh = FakeMesh(**sizes)
        got = tshd.tree_specs(axes, shapes, mesh)
        want = jshd.tree_specs(axes, shapes, mesh)
        flat = lambda t: [tuple(t["a"]), tuple(t["b"]["c"]),  # noqa: E731
                          tuple(t["b"]["d"]), tuple(t["e"][0]),
                          tuple(t["e"][1])]
        assert flat(got) == flat(want)
        sh = tshd.tree_shardings(axes, shapes, mesh)
        assert sh["a"].spec == got["a"] and sh["a"].mesh is mesh


# the cases of tests/test_sharding.py::TestResolution: mesh, logical
# axes, shape, rule overrides, expected spec
CASES = {
    "basic_rules": (dict(data=16, model=16), ("vocab", "embed"),
                    (49152, 576), None, ("model", "data")),
    "divisibility_fallback": (dict(data=16, model=16), ("embed", "heads"),
                              (576, 9), None, ("data",)),
    "axis_used_once": (dict(data=16, model=16), ("batch", "seq", "embed"),
                       (256, 4096, 8192), None, ("data",)),
    "multi_axis_batch": (dict(pod=2, data=16, model=16), ("batch", None),
                         (256, 10), None, (("pod", "data"),)),
    "missing_mesh_axis_ignored": (dict(data=8), ("embed", "mlp"), (64, 256),
                                  None, ("data",)),
    "rules_override": (dict(data=16, model=16), ("embed", "mlp"), (64, 256),
                       dict(embed=None, mlp="data"), (None, "data")),
    "pure_dp_style": (dict(pod=2, data=16, model=16), ("batch", "seq", None),
                      (512, 128, 64), dict(batch=("pod", "data", "model")),
                      (("pod", "data", "model"),)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_resolution_cases(case):
    sizes, axes, shape, rules, want = CASES[case]
    mesh = FakeMesh(**sizes)
    assert _tspec(axes, shape, mesh, rules) == want
    assert _jspec(axes, shape, mesh, rules) == want


def test_constrain_is_a_noop_without_a_mesh():
    import torch
    tshd.set_mesh(None)
    x = torch.ones(4, 4)
    assert tshd.constrain(x, ("batch", "embed")) is x


def test_use_mesh_context_restores():
    mesh = FakeMesh(data=1, model=1)
    assert tshd._ACTIVE["mesh"] is None
    with tshd.use_mesh(mesh):
        assert tshd._ACTIVE["mesh"] is mesh
        # a plain tensor passes through an active mesh unchanged
        import torch
        x = torch.ones(2)
        assert tshd.constrain(x, ("embed",)) is x
    assert tshd._ACTIVE["mesh"] is None


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Named:
        mesh_dim_names = ("pod", "data", "model")

    assert tshd.spec_to_placements(tshd.P(("pod", "data")), Named()) == \
        (Shard(0), Shard(0), Replicate())
    assert tshd.spec_to_placements(tshd.P(None, "model"), Named()) == \
        (Replicate(), Replicate(), Shard(1))
    assert tshd.spec_to_placements(tshd.P(), Named()) == (Replicate(),) * 3


def test_meshes_need_a_process_group():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh()
