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

All seven routes of the reference are registered, with its capabilities:
``sodm``, ``dsvrg`` and the Section-4 baselines ``cascade``, ``dip``,
``dc``, ``svrg`` and ``csvrg``. ``dsvrg`` and ``cascade`` also train from
a ``ShardedSource`` out of core (``streaming_routes()``; the ``y is
None`` branch of their fits). ``sodm`` and ``dsvrg`` are mesh-aware:
given a ``torch.distributed`` device mesh they run their SPMD drivers
(``sodm._solve_sharded``, the sharded DSVRG), and a mesh on another route,
or with a streaming source, raises the reference's ``ValueError``. The
``sodm`` and ``dsvrg`` routes, and
both streaming routes, take the reference's ``faults``/``tracker``/
``resume`` seams; the resident rival routes take the tracker only, which
the reference rejects on them (a known difference: the port reads their
per-level and per-epoch times through it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

from repro_torch.core import baselines as baselines_mod
from repro_torch.core import dsvrg as dsvrg_mod
from repro_torch.core import sodm as sodm_mod
from repro_torch.serve import model as serve_model

DSVRG_AUTO_THRESHOLD = sodm_mod.SODMConfig.dsvrg_threshold

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
        if mesh is not None and not self.mesh_aware:
            raise ValueError(
                f"route {self.name!r} has no SPMD driver but a mesh was "
                f"given — its capabilities: {self.capabilities()}. "
                f"Mesh-aware routes: "
                f"{[e.name for e in _REGISTRY.values() if e.mesh_aware]}")
        if streaming and not self.streaming:
            raise ValueError(
                f"route {self.name!r} cannot train from a ShardedSource — "
                f"its capabilities: {self.capabilities()}. Streaming routes: "
                f"{streaming_routes()}")
        if streaming and mesh is not None:
            raise ValueError(
                "streaming fits have no SPMD driver yet (ROADMAP open "
                "item 2: mesh-sharded shard ingestion) — drop the mesh or "
                "materialize the source")


_REGISTRY: dict[str, SolverEntry] = {}


def register(entry: SolverEntry) -> SolverEntry:
    """Add a route. Duplicate names raise (no silent shadowing)."""
    if entry.name in _REGISTRY:
        raise ValueError(f"route {entry.name!r} is already registered")
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> SolverEntry:
    """Look a route up by name; an unknown name raises ``ValueError``."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(f"unknown route {name!r}; registered routes: "
                     f"{routes()}")


def routes() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def streaming_routes() -> list[str]:
    """Route names that can consume a ShardedSource out of core."""
    return [e.name for e in _REGISTRY.values() if e.streaming]


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


def _hooks(fit_kw) -> dict:
    """The preemption/observability seams of the instrumented routes,
    forwarded from ``ODMEstimator.fit(faults=, tracker=, resume=)``."""
    return {k: fit_kw[k] for k in ("faults", "tracker", "resume")
            if fit_kw.get(k) is not None}


def _stream_hooks(fit_kw) -> dict:
    """:func:`_hooks` plus what only the streaming drivers take: the
    loader knobs (prefetch ``depth``, injected ``executor``/``metrics``,
    the host-byte ``accountant``) and the ``device`` the slabs go to."""
    kw = _hooks(fit_kw)
    kw.update({k: fit_kw[k]
               for k in ("depth", "executor", "metrics", "accountant",
                         "device")
               if fit_kw.get(k) is not None})
    return kw


def _fit_sodm(problem, x, y, key, *, cfg, mesh=None, data_axis="data",
              auto=False, compile_kw, fit_kw) -> RouteOutput:
    del auto
    cfg = _pin_level_engine(cfg, "sodm")
    if mesh is None:
        res = sodm_mod._solve(problem.kernel, x, y, problem.params, cfg,
                              key, fit_kw.get("level_callback"),
                              **_hooks(fit_kw))
    else:
        res = sodm_mod._solve_sharded(problem.kernel, x, y, problem.params,
                                      cfg, key, mesh, data_axis=data_axis,
                                      **_hooks(fit_kw))
    model = serve_model.from_sodm(problem.kernel, res, x, y, **compile_kw)
    return RouteOutput(model=model, raw=res, engine=cfg.engine,
                       passes=tuple(res.sweeps_per_level),
                       kkt=float(res.kkt))


def _fit_dsvrg(problem, x, y, key, *, cfg, mesh=None, data_axis="data",
               auto=False, compile_kw, fit_kw) -> RouteOutput:
    del compile_kw                     # the artifact is the primal w
    if y is None:                      # x is a ShardedSource (streaming fit)
        dres, kkt = dsvrg_mod._solve_stream(x, problem.params, cfg.dsvrg,
                                            key, **_stream_hooks(fit_kw))
        # the resident path's dual recovery is O(M) state: a streaming
        # fit compiles the artifact straight from the primal w
        model = serve_model.FittedODM(spec=problem.kernel, w=dres.w,
                                      n_train=int(x.n_rows),
                                      compression="linear")
        return RouteOutput(model=model, raw=dres, engine="dsvrg",
                           passes=(len(dres.history),), kkt=float(kkt),
                           eta=float(dres.eta),
                           history=tuple(float(h) for h in dres.history))
    res, dres = sodm_mod._solve_dsvrg(problem.kernel, x, y, problem.params,
                                      cfg, key, mesh=mesh,
                                      data_axis=data_axis, auto=auto,
                                      **_hooks(fit_kw))
    model = dataclasses.replace(serve_model.from_dsvrg(dres),
                                spec=problem.kernel)
    return RouteOutput(model=model, raw=dres, engine="dsvrg",
                       passes=(len(dres.history),), kkt=float(res.kkt),
                       eta=float(dres.eta),
                       history=tuple(float(h) for h in dres.history))


def _fit_cascade(problem, x, y, key, *, cfg, mesh=None, data_axis="data",
                 auto=False, compile_kw, fit_kw) -> RouteOutput:
    if y is None:                      # x is a ShardedSource (streaming fit)
        res = baselines_mod._cascade_solve_stream(
            problem.kernel, x, problem.params, levels=cfg.levels, key=key,
            tol=cfg.tol, max_sweeps=cfg.max_sweeps, **_stream_hooks(fit_kw))
    else:
        res = baselines_mod._cascade_solve(problem.kernel, x, y,
                                           problem.params, levels=cfg.levels,
                                           key=key, tol=cfg.tol,
                                           max_sweeps=cfg.max_sweeps,
                                           tracker=fit_kw.get("tracker"))
    model = serve_model.from_cascade(problem.kernel, res, **compile_kw)
    return RouteOutput(model=model, raw=res, engine="scalar",
                       passes=(res.levels_run,))


def _fit_dip(problem, x, y, key, *, cfg, mesh=None, data_axis="data",
             auto=False, compile_kw, fit_kw) -> RouteOutput:
    cfg = _pin_level_engine(cfg, "dip")
    res = baselines_mod._dip_solve(problem.kernel, x, y, problem.params,
                                   cfg, key, tracker=fit_kw.get("tracker"))
    model = serve_model.from_sodm(problem.kernel, res, x, y, **compile_kw)
    return RouteOutput(model=model, raw=res, engine=cfg.engine,
                       passes=tuple(res.sweeps_per_level),
                       kkt=float(res.kkt))


def _fit_dc(problem, x, y, key, *, cfg, mesh=None, data_axis="data",
            auto=False, compile_kw, fit_kw) -> RouteOutput:
    cfg = _pin_level_engine(cfg, "dc")
    res = baselines_mod._dc_solve(problem.kernel, x, y, problem.params,
                                  cfg, key, tracker=fit_kw.get("tracker"))
    model = serve_model.from_sodm(problem.kernel, res, x, y, **compile_kw)
    return RouteOutput(model=model, raw=res, engine=cfg.engine,
                       passes=tuple(res.sweeps_per_level),
                       kkt=float(res.kkt))


def _grad_eta(x, cfg, params) -> float:
    d = cfg.dsvrg
    return d.eta if d.eta > 0 else dsvrg_mod.auto_eta(x, params)


def _grad_output(problem, x, res, name: str, epochs: int,
                 eta: float) -> RouteOutput:
    model = serve_model.FittedODM(spec=problem.kernel, w=res.w,
                                  n_train=int(x.shape[0]),
                                  compression="linear")
    return RouteOutput(model=model, raw=res, engine=name, passes=(epochs,),
                       eta=float(eta),
                       history=tuple(float(h) for h in res.history))


def _fit_svrg(problem, x, y, key, *, cfg, mesh=None, data_axis="data",
              auto=False, compile_kw, fit_kw) -> RouteOutput:
    del compile_kw, fit_kw
    d = cfg.dsvrg
    eta = _grad_eta(x, cfg, problem.params)
    res = baselines_mod._svrg_solve(x, y, problem.params, epochs=d.epochs,
                                    eta=eta, key=key, batch=d.batch)
    return _grad_output(problem, x, res, "svrg", d.epochs, eta)


def _fit_csvrg(problem, x, y, key, *, cfg, mesh=None, data_axis="data",
               auto=False, compile_kw, fit_kw) -> RouteOutput:
    del compile_kw, fit_kw
    d = cfg.dsvrg
    eta = _grad_eta(x, cfg, problem.params)
    res = baselines_mod._csvrg_solve(x, y, problem.params, epochs=d.epochs,
                                     eta=eta, key=key,
                                     coreset_frac=d.coreset_frac,
                                     batch=d.batch)
    return _grad_output(problem, x, res, "csvrg", d.epochs, eta)


register(SolverEntry(
    name="sodm", fit=_fit_sodm,
    algorithm="Alg. 1 (hierarchical partitioned dual CD)",
    kernels=None, mesh_aware=True, matrix_free=True,
    description="stratified partitions, warm-started level merges; level "
                "engines scalar | block | pallas"))
register(SolverEntry(
    name="dsvrg", fit=_fit_dsvrg,
    algorithm="Alg. 2 (communication-efficient SVRG)",
    kernels=_LINEAR, mesh_aware=True, matrix_free=True, streaming=True,
    scale_min=DSVRG_AUTO_THRESHOLD,
    description="primal round-robin SVRG; dual recovered via "
                "odm.alpha_from_w; auto-selected for big linear problems; "
                "accepts a ShardedSource (out-of-core epochs)"))
register(SolverEntry(
    name="cascade", fit=_fit_cascade,
    algorithm="Ca-ODM (Graf et al. 2004 cascade)",
    kernels=None, mesh_aware=False, matrix_free=False, streaming=True,
    description="binary support-vector funnel; fast but lossy baseline; "
                "accepts a ShardedSource (leaves train as shards arrive)"))
register(SolverEntry(
    name="dip", fit=_fit_dip,
    algorithm="DiP-ODM (Singh et al. 2017)",
    kernels=None, mesh_aware=False, matrix_free=False,
    description="k-means strata dealt round-robin, then the SODM merge"))
register(SolverEntry(
    name="dc", fit=_fit_dc,
    algorithm="DC-ODM (Hsieh et al. 2014)",
    kernels=None, mesh_aware=False, matrix_free=False,
    description="k-means clusters as partitions, then the SODM merge"))
register(SolverEntry(
    name="svrg", fit=_fit_svrg,
    algorithm="single-chain SVRG (Johnson & Zhang 2013)",
    kernels=_LINEAR, mesh_aware=False, matrix_free=False,
    description="gradient baseline; eta <= 0 takes the auto smoothness "
                "step"))
register(SolverEntry(
    name="csvrg", fit=_fit_csvrg,
    algorithm="coreset SVRG (Tan et al. 2019)",
    kernels=_LINEAR, mesh_aware=False, matrix_free=False,
    description="anchor gradients on a k-center coreset "
                "(DSVRGConfig.coreset_frac)"))
