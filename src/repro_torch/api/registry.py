"""Capability-based solver registry — the port's training routes.

Port of ``repro.api.registry``. The resolution policy is the reference's,
rule for rule:

* an explicit ``route=`` always wins, and a problem outside the route's
  capabilities raises ``ValueError`` listing them;
* otherwise (``route=None``) the paper's dispatch: an ``SODMConfig.engine``
  pinned to a level engine stays on ``sodm`` whatever the size;
  ``engine="dsvrg"`` demands ``dsvrg`` (linear kernel required); an unset
  engine sends linear-kernel problems with M >= ``dsvrg_threshold`` to
  ``dsvrg``; streaming fits go to ``dsvrg`` (linear) or ``cascade``.

Ported: ``sodm`` and ``dsvrg`` (resident data; streaming is ROADMAP A14).
A route that resolves but is not ported yet raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

from repro_torch.core import sodm as sodm_mod
from repro_torch.serve import model as serve_model

DSVRG_AUTO_THRESHOLD = sodm_mod.SODMConfig.dsvrg_threshold

#: routes of the reference not ported yet, with their ROADMAP item
UNPORTED = {
    "cascade": "A10", "dip": "A10", "dc": "A10", "svrg": "A10",
    "csvrg": "A10",
}

_LINEAR = frozenset({"linear"})


class RouteOutput(NamedTuple):
    """What a route's ``fit`` hands back to the estimator."""

    model: serve_model.FittedODM
    raw: object
    engine: str
    passes: tuple[int, ...]
    kkt: float | None = None
    eta: float | None = None
    history: tuple[float, ...] | None = None


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    """One registered training route and its declared capabilities."""

    name: str
    fit: Callable[..., RouteOutput]
    algorithm: str
    kernels: frozenset[str] | None = None   # None = every KernelSpec family
    mesh_aware: bool = False
    matrix_free: bool = False
    streaming: bool = False
    scale_min: int = 0
    scale_max: int | None = None
    description: str = ""

    def capabilities(self) -> str:
        kern = "all kernels" if self.kernels is None \
            else "kernels {" + ", ".join(sorted(self.kernels)) + "}"
        band = f"M in [{self.scale_min}, " + \
            (f"{self.scale_max}]" if self.scale_max is not None else "inf)")
        return (f"{self.name}: {self.algorithm}; {kern}; "
                f"mesh_aware={self.mesh_aware}; "
                f"matrix_free={self.matrix_free}; "
                f"streaming={self.streaming}; {band}")

    def check(self, kernel_name: str, M: int, mesh=None,
              streaming: bool = False) -> None:
        """Raise ``ValueError`` (listing capabilities) on incompatibility."""
        if self.kernels is not None and kernel_name not in self.kernels:
            raise ValueError(
                f"route {self.name!r} does not support kernel "
                f"{kernel_name!r} — its capabilities: {self.capabilities()}")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device fits are not ported yet (ROADMAP A13)")
        if streaming and not self.streaming:
            raise ValueError(
                f"route {self.name!r} cannot train from a ShardedSource — "
                f"its capabilities: {self.capabilities()}")


_REGISTRY: dict[str, SolverEntry] = {}


def register(entry: SolverEntry) -> SolverEntry:
    """Add a route. Duplicate names raise (no silent shadowing)."""
    if entry.name in _REGISTRY:
        raise ValueError(f"route {entry.name!r} is already registered")
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> SolverEntry:
    """Look a route up by name. A reference route not ported yet raises
    ``NotImplementedError``; an unknown name raises ``ValueError``."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in UNPORTED:
        raise NotImplementedError(
            f"route {name!r} is not ported yet (ROADMAP {UNPORTED[name]})")
    raise ValueError(f"unknown route {name!r}; registered routes: "
                     f"{routes()}")


def routes() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve(problem, M: int, mesh=None, route: str | None = None, cfg=None,
            streaming: bool = False) -> SolverEntry:
    """Explicit route wins, else the paper's auto rule."""
    kernel_name = getattr(getattr(problem, "kernel", problem), "name")
    if route is not None:
        entry = get(route)
        if entry.name != "dsvrg" and getattr(cfg, "engine", None) == "dsvrg":
            raise ValueError(
                f"route={route!r} with SODMConfig.engine='dsvrg' is "
                f"contradictory — use route='dsvrg', or leave route unset")
        entry.check(kernel_name, M, mesh, streaming)
        return entry
    return resolve_auto(
        kernel_name, M, engine=getattr(cfg, "engine", None),
        threshold=getattr(cfg, "dsvrg_threshold", DSVRG_AUTO_THRESHOLD),
        mesh=mesh, streaming=streaming)


def resolve_auto(kernel_name: str, M: int, *, engine: str | None = None,
                 threshold: int = DSVRG_AUTO_THRESHOLD, mesh=None,
                 streaming: bool = False) -> SolverEntry:
    """The paper's linear-kernel dispatch (Section 3.3)."""
    if streaming:
        name = "dsvrg" if engine == "dsvrg" or kernel_name == "linear" \
            else "cascade"
    elif engine == "dsvrg":
        name = "dsvrg"
    elif engine is None and kernel_name == "linear" and M >= threshold:
        name = "dsvrg"
    else:
        name = "sodm"
    entry = get(name)
    entry.check(kernel_name, M, mesh, streaming)
    return entry


def dsvrg_partition_count(M: int, want: int, n_dev: int = 1) -> int:
    """Largest K <= ``want`` that divides M and is a multiple of ``n_dev``
    (the dsvrg route's partition clamp)."""
    K = max(want - want % n_dev, n_dev)
    while K >= n_dev:
        if M % K == 0:
            return K
        K -= n_dev
    raise ValueError(
        f"no DSVRG partition count <= {want} divides M={M} and is a "
        f"multiple of the data axis size {n_dev}")


def _pin_level_engine(cfg, route: str):
    """An explicit route is never re-routed by the level loop's own auto
    dispatch: ``engine=None`` runs as ``"scalar"`` inside the loop, so pin
    it; ``engine="dsvrg"`` with a level route raises."""
    if cfg.engine == "dsvrg":
        raise ValueError(
            f"route={route!r} with SODMConfig.engine='dsvrg' is "
            f"contradictory — use route='dsvrg', or leave route unset")
    if cfg.engine is None:
        return dataclasses.replace(cfg, engine="scalar")
    return cfg


def _fit_sodm(problem, x, y, key, *, cfg, compile_kw,
              fit_kw) -> RouteOutput:
    cfg = _pin_level_engine(cfg, "sodm")
    res = sodm_mod._solve(problem.kernel, x, y, problem.params, cfg, key,
                          fit_kw.get("level_callback"),
                          tracker=fit_kw.get("tracker"))
    model = serve_model.from_sodm(problem.kernel, res, x, y, **compile_kw)
    return RouteOutput(model=model, raw=res, engine=cfg.engine,
                       passes=tuple(res.sweeps_per_level),
                       kkt=float(res.kkt))


def _fit_dsvrg(problem, x, y, key, *, cfg, compile_kw,
               fit_kw) -> RouteOutput:
    del compile_kw                     # the artifact is the primal w
    res, dres = sodm_mod._solve_dsvrg(problem.kernel, x, y, problem.params,
                                      cfg, key,
                                      tracker=fit_kw.get("tracker"))
    model = dataclasses.replace(serve_model.from_dsvrg(dres),
                                spec=problem.kernel)
    return RouteOutput(model=model, raw=dres, engine="dsvrg",
                       passes=(len(dres.history),), kkt=float(res.kkt),
                       eta=float(dres.eta),
                       history=tuple(float(h) for h in dres.history))


register(SolverEntry(
    name="sodm", fit=_fit_sodm,
    algorithm="Alg. 1 (hierarchical partitioned dual CD)",
    kernels=None, mesh_aware=False, matrix_free=True,
    description="stratified partitions, warm-started level merges; level "
                "engines scalar | block | pallas"))
register(SolverEntry(
    name="dsvrg", fit=_fit_dsvrg,
    algorithm="Alg. 2 (communication-efficient SVRG)",
    kernels=_LINEAR, mesh_aware=False, matrix_free=True,
    scale_min=DSVRG_AUTO_THRESHOLD,
    description="primal round-robin SVRG; dual recovered via "
                "odm.alpha_from_w; auto-selected for big linear problems"))
