"""repro_torch.analysis — plan-level checks of the port (port of
``repro.analysis``).

* :mod:`~repro_torch.analysis.launch_lint` — records a run's dispatch
  plan (kernel dispatches, host syncs, gathers, collectives, each under
  its span path) and checks declarative rules over it (counterpart of
  ``jaxpr_lint``).
* :mod:`~repro_torch.analysis.hopper_check` — each kernel's launch plan
  (threads, shared memory, registers, CTAs an SM) against the H100's
  limits, and on the card against the built library's own attributes
  (counterpart of ``pallas_check``).
* :mod:`~repro_torch.analysis.invariants` — the process-wide counters
  and the registry where kernels, routes and components declare their
  invariants; one battery verifies every declaration.
* :mod:`~repro_torch.analysis.boundary_lint` — AST lint of the port's
  conventions (``python -m repro_torch.analysis.boundary_lint``).

The submodules load lazily, as the reference's do.
"""
from __future__ import annotations

_SUBMODULES = ("launch_lint", "hopper_check", "invariants", "boundary_lint")


def __getattr__(name: str):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
