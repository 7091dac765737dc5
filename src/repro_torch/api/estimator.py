"""``ODMEstimator`` — the one front door for training and serving ODMs.

Port of ``repro.api.estimator`` for the ``sodm`` and ``dsvrg`` routes:

    est = ODMEstimator(ProblemSpec.create("rbf", gamma=0.5, lam=100.0),
                       cfg=SODMConfig(engine="pallas"))
    model, report = est.fit(x, y, 0)      # runs on the card
    est.predict(x_test)

``device=None`` means the card; with no CUDA device the constructor
raises and says to pass ``device="cpu"``, which runs every kernel's plain
PyTorch version. ``fit`` validates the data once, resolves the route,
runs it and returns a deployable :class:`FittedODM` plus a
:class:`FitReport`. ``resume``/``faults`` (ROADMAP A12), ``profile_dir``
(A15), streaming sources (A14) and ``save``/``load`` (A7) are not ported
yet and raise.
"""
from __future__ import annotations

import time

import torch

from repro_torch.api import registry
from repro_torch.api.report import FitReport
from repro_torch.api.spec import ProblemSpec
from repro_torch.core import kernel_fns as kf
from repro_torch.core import odm as odm_mod
from repro_torch.core.sodm import SODMConfig
from repro_torch.kernels._device import resolve_device
from repro_torch.observe.spans import span, trace_ctx
from repro_torch.serve import model as serve_model

Tensor = torch.Tensor


class ODMEstimator:
    """Facade over the solver registry with sklearn-flavored verbs.

    problem: a :class:`ProblemSpec` (a bare ``KernelSpec`` is wrapped with
        default ``ODMParams``); ``None`` is the default rbf problem.
    route: registry route name, or ``None`` for the auto policy.
    cfg: the ``SODMConfig`` of the solve.
    prune_tol / budget / target: artifact compression knobs.
    device: ``None`` or ``"cuda"`` runs on the card (the hand-written
        kernels); ``"cpu"`` runs their plain versions.
    """

    def __init__(self, problem: ProblemSpec | kf.KernelSpec | None = None,
                 *, route: str | None = None,
                 cfg: SODMConfig | None = None, prune_tol: float = 0.0,
                 budget: int | None = None, target: float | None = None,
                 device: str | torch.device | None = None):
        if problem is None:
            problem = ProblemSpec()
        elif isinstance(problem, kf.KernelSpec):
            problem = ProblemSpec(kernel=problem)
        self.problem = problem
        if route is not None:
            registry.get(route)            # unknown route: fail eagerly
        self.route = route
        self.cfg = cfg if cfg is not None else SODMConfig()
        self.device = resolve_device(device)
        self.compile_kw = {"prune_tol": prune_tol, "budget": budget,
                           "target": target}
        self.model_: serve_model.FittedODM | None = None
        self.report_: FitReport | None = None

    def fit(self, x, y=None, key: torch.Generator | int | None = None, *,
            resume=None, faults=None, tracker=None, profile_dir=None,
            trace_dir=None, **fit_kw
            ) -> tuple[serve_model.FittedODM, FitReport]:
        """Train through the resolved route; returns (artifact, report).

        ``key`` seeds the partitioning (a ``torch.Generator`` or an int;
        ``None`` is seed 0). ``tracker`` receives per-level metrics and one
        final summary; ``trace_dir`` exports host spans (fit → route →
        cascade.level) to ``<trace_dir>/trace.json``. ``fit_kw`` forwards
        ``level_callback``.
        """
        if y is None:
            raise NotImplementedError(
                "streaming fits from a ShardedSource are not ported yet "
                "(ROADMAP A14)")
        if resume is not None or faults is not None:
            raise NotImplementedError(
                "resume/faults are not ported yet (ROADMAP A12)")
        if profile_dir is not None:
            raise NotImplementedError(
                "profile_dir is not ported yet (ROADMAP A15)")
        x, y = self.problem.validate(x, y, self.device)
        M = int(x.shape[0])
        entry = registry.resolve(self.problem, M, route=self.route,
                                 cfg=self.cfg)
        if tracker is not None:
            fit_kw["tracker"] = tracker
        t0 = time.perf_counter()
        with trace_ctx(trace_dir), span("fit", route=entry.name, n_train=M,
                                        device=str(self.device)):
            with span(f"route.{entry.name}", engine=self.cfg.engine):
                out = entry.fit(self.problem, x, y, key, cfg=self.cfg,
                                compile_kw=dict(self.compile_kw),
                                fit_kw=fit_kw)
            if self.device.type == "cuda":
                with span("fit.synchronize"):
                    torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        report = FitReport(
            route=entry.name, engine=out.engine, algorithm=entry.algorithm,
            n_train=M, n_sv=out.model.n_sv,
            compression=out.model.compression, wall_clock=wall,
            passes=out.passes, kkt=out.kkt, eta=out.eta,
            history=out.history, gap=out.model.gap, raw=out.raw)
        if tracker is not None:
            tracker.log_metrics(len(out.passes), {
                "route": entry.name, "engine": out.engine, "fit_done": True,
                "n_train": M, "n_sv": out.model.n_sv, "kkt": out.kkt,
                "wall_clock": wall, "rows_per_s": M / max(wall, 1e-9)})
        self.model_, self.report_ = out.model, report
        return out.model, report

    def _fitted(self) -> serve_model.FittedODM:
        if self.model_ is None:
            raise ValueError(
                "this ODMEstimator is not fitted — call fit(x, y) first")
        return self.model_

    def decision_function(self, x, **kw) -> Tensor:
        """f(x) (T,) through the served scoring path."""
        return self._fitted().decision_function(x, **kw)

    def predict(self, x, **kw) -> Tensor:
        """sign(f(x)) in {-1, +1}."""
        return self._fitted().predict(x, **kw)

    def score(self, x, y) -> float:
        """Accuracy of :meth:`predict` against ±1 labels."""
        pred = self.predict(x)
        y = torch.as_tensor(y, dtype=pred.dtype, device=pred.device)
        return float(odm_mod.accuracy(y, pred))

    def save(self, directory: str) -> str:
        return self._fitted().save(directory)
