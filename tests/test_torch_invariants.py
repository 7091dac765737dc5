"""The port's invariant registry (repro_torch.analysis.invariants, port of
repro.analysis.invariants): one parametrised battery over the declared
names (each declaration counts as a test; the multi-process one is
marked slow), duplicate and unknown names raise, every kernel, route and
component has a declaration, and the port's routes and components are
the reference's."""
import pytest

from repro.analysis import invariants as jinv
from repro.api import registry as jreg
from repro_torch.analysis import hopper_check as hc
from repro_torch.analysis import invariants as inv
from repro_torch.api import registry

_ALL = inv.invariants()


def test_duplicate_declaration_raises():
    with pytest.raises(ValueError, match="already declared"):
        inv.declare(_ALL[0])


def test_unknown_name_lists_declared():
    with pytest.raises(KeyError, match="no invariant"):
        inv.get("kernels.nope.never")
    with pytest.raises(ValueError, match="kind must be"):
        inv.Invariant(name="x", subject="y", kind="other", description="",
                      verify=lambda device: None)


def test_counters_are_shared_objects():
    from repro_torch.core import sodm
    from repro_torch.kernels import gram
    assert gram.gram.launches is inv.counter("launch.gram")
    assert sodm.level_solve_count() == inv.counter("sodm.level_solve").count


def test_every_kernel_route_and_component_is_covered():
    kernels = {i.subject for i in _ALL if i.kind == "kernel"}
    assert kernels == set(hc.PLAN_BUILDERS), (
        f"kernels missing a declared invariant: "
        f"{set(hc.PLAN_BUILDERS) - kernels}")
    routes = {i.subject for i in _ALL if i.kind == "route"}
    assert routes == set(registry.routes()), (
        f"routes missing a declared invariant: "
        f"{set(registry.routes()) - routes}")
    comps = {i.subject for i in _ALL if i.kind == "component"}
    assert comps == set(inv.COMPONENTS), (
        f"components missing a declared invariant: "
        f"{set(inv.COMPONENTS) - comps}")
    for kernel in hc.PLAN_BUILDERS:
        assert f"kernels.{kernel}.single_launch" in {i.name for i in _ALL}
        assert f"kernels.{kernel}.smem_plan" in {i.name for i in _ALL}


def test_routes_and_components_are_the_references():
    assert tuple(registry.routes()) == tuple(jreg.routes())
    assert inv.COMPONENTS == jinv.COMPONENTS
    ref_routes = {i.name for i in jinv.invariants() if i.kind == "route"}
    ours = {i.name for i in _ALL if i.kind == "route"}
    # every reference route pin has a counterpart; dsvrg.trace_once and
    # the epoch-scan shape become one_epoch_launch (no jit trace in the
    # port), the gather-once pin a gather-free decision_function
    assert {n for n in ref_routes if ".facade_artifact" in n} <= ours
    assert {"routes.dsvrg.one_epoch_launch",
            "routes.sodm.predict_gather_once",
            "routes.dsvrg.sharded_gather_hoisted"} <= ours
    ref_comp = {i.name for i in jinv.invariants() if i.kind == "component"}
    assert ref_comp == {i.name for i in _ALL if i.kind == "component"}


@pytest.mark.parametrize("name", [i.name for i in _ALL if not i.slow])
def test_invariant(name):
    """The uniform battery: every quick declared invariant verifies on the
    CPU (tests/test_torch_cuda.py runs verify_all on the card)."""
    inv.verify(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", [i.name for i in _ALL if i.slow])
def test_invariant_slow(name):
    inv.verify(name)


def test_verify_all_quick_tier():
    got = inv.verify_all()
    assert set(got) == {i.name for i in _ALL if not i.slow}
