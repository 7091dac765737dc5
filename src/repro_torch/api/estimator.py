"""``ODMEstimator`` — the one front door for training and serving ODMs.

Port of ``repro.api.estimator``, for every route of the registry:

    est = ODMEstimator(ProblemSpec.create("rbf", gamma=0.5, lam=100.0),
                       cfg=SODMConfig(engine="pallas"))
    model, report = est.fit(x, y, 0)      # runs on the card
    est.predict(x_test)
    est.save("model_dir"); ODMEstimator.load("model_dir")

``device=None`` means the card; with no CUDA device the constructor
raises and says to pass ``device="cpu"``, which runs every kernel's plain
PyTorch version. ``fit`` validates the data once, resolves the route,
runs it and returns a deployable :class:`FittedODM` plus a
:class:`FitReport`. ``save``/``load`` persist the artifact in the
reference's checkpoint layout, so either package loads the other's.
``fit(resume=..., faults=...)`` makes the sodm and dsvrg routes
preemption-proof, as in the reference. ``fit(source)`` trains the dsvrg
or cascade route out of core from a
:class:`repro_torch.data.streaming.ShardedSource`, each slab copied to the
estimator's device. ``ODMEstimator(mesh=...)`` fits the mesh-aware
routes (sodm, dsvrg) SPMD over a ``torch.distributed`` device mesh: every
rank constructs the estimator and calls ``fit`` with the same arguments,
and each gets the same model on its own device. ``fit(profile_dir=...)``
records the fit with ``torch.profiler`` (CUDA activity on the card) into
``<profile_dir>/profile.json``.
"""
from __future__ import annotations

import time

import torch

from repro_torch import sharding as shd
from repro_torch.api import registry
from repro_torch.api.report import FitReport
from repro_torch.api.spec import ProblemSpec
from repro_torch.core import kernel_fns as kf
from repro_torch.core import odm as odm_mod
from repro_torch.core.sodm import SODMConfig
from repro_torch.kernels._device import resolve_device
from repro_torch.observe.profiler import profile_ctx
from repro_torch.observe.spans import span, trace_ctx
from repro_torch.serve import model as serve_model

Tensor = torch.Tensor


class ODMEstimator:
    """Facade over the solver registry with sklearn-flavored verbs.

    problem: a :class:`ProblemSpec` (a bare ``KernelSpec`` is wrapped with
        default ``ODMParams``); ``None`` is the default rbf problem.
    route: registry route name, or ``None`` for the auto policy.
    cfg: the ``SODMConfig`` of the solve.
    mesh / data_axis: SPMD placement for the mesh-aware routes (a
        ``torch.distributed`` device mesh and the axis its partitions
        shard over).
    prune_tol / budget / target: artifact compression knobs.
    device: ``None`` or ``"cuda"`` runs on the card (the hand-written
        kernels); ``"cpu"`` runs their plain versions. With a mesh,
        ``None`` means this rank's device of the mesh, and another device
        type than the mesh's raises.
    """

    def __init__(self, problem: ProblemSpec | kf.KernelSpec | None = None,
                 *, route: str | None = None,
                 cfg: SODMConfig | None = None, mesh=None,
                 data_axis: str = "data", prune_tol: float = 0.0,
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
        self.mesh = mesh
        self.data_axis = data_axis
        if mesh is not None:
            mesh_dev = shd.mesh_device(mesh)
            if device is not None and \
                    torch.device(device).type != mesh_dev.type:
                raise ValueError(
                    f"device={device!r} differs from the mesh's device "
                    f"type {mesh.device_type!r}")
            device = mesh_dev
        self.device = resolve_device(device)
        self.compile_kw = {"prune_tol": prune_tol, "budget": budget,
                           "target": target}
        self.model_: serve_model.FittedODM | None = None
        self.report_: FitReport | None = None

    #: routes with a resume/faults seam (the paper's two regimes; the
    #: Section-4 rivals have no mid-solve state worth persisting)
    INSTRUMENTED_ROUTES = ("dsvrg", "sodm")
    #: the streaming routes' resume/faults seams (both checkpoint)
    STREAM_INSTRUMENTED_ROUTES = ("dsvrg", "cascade")

    def fit(self, x, y=None, key: torch.Generator | int | None = None, *,
            resume=None, faults=None, tracker=None, profile_dir=None,
            trace_dir=None, **fit_kw
            ) -> tuple[serve_model.FittedODM, FitReport]:
        """Train through the resolved route; returns (artifact, report).

        ``x`` is either a dense ``(M, d)`` feature matrix with ``y`` its
        ±1 labels, or a :class:`repro_torch.data.streaming.ShardedSource`
        with ``y`` omitted (a source carries its own labels). A source
        streams through an out-of-core route (dsvrg for linear kernels,
        cascade otherwise; ``registry.streaming_routes``) slab by slab
        onto the estimator's device, never materializing the (M, d)
        matrix; ``fit_kw`` then also takes the loader knobs ``depth``,
        ``executor``, ``metrics`` and ``accountant``, which a dense fit
        rejects.

        ``key`` seeds the partitioning (a ``torch.Generator`` or an int;
        ``None`` is seed 0). ``tracker`` receives per-level metrics and one
        final summary, on every route (the reference rejects it on the
        rival routes; the port's rivals report their levels and epochs
        through it); ``trace_dir`` exports host spans (fit → route →
        cascade.level) to ``<trace_dir>/trace.json``; ``profile_dir``
        records the fit with ``torch.profiler`` (the kernels' device time
        when the estimator runs on the card) into
        ``<profile_dir>/profile.json``. ``fit_kw`` forwards
        ``level_callback``.

        Preemption-proofing (sodm and dsvrg routes, and both streaming
        routes; the others raise rather than silently ignore these):

        resume: a directory (or :class:`repro_torch.distributed.resume
            .ResumeConfig`) holding mid-solve checkpoints, written per
            level / per DSVRG segment as the solve progresses. A directory
            left behind by a preempted fit restarts at the first unsolved
            level or epoch, and the result equals the uninterrupted fit's
            bit for bit. The provenance (kernel, params, cfg, data, key)
            is fingerprinted: resuming against another problem raises.
            A ``torch.Generator`` key is fingerprinted before the
            partitioning draws from it, so a resume needs a generator in
            the same state, not the one the killed fit consumed.
        faults: a :class:`repro_torch.distributed.faults.FaultPlan` for
            deterministic chaos testing (kill at a level or an epoch,
            kill inside the checkpoint's crash window).
        """
        from repro_torch.data.streaming import is_source
        streaming = is_source(x)
        if streaming:
            if y is not None:
                raise ValueError(
                    "fit(source) carries its own labels — passing y "
                    "alongside a ShardedSource is ambiguous; drop y")
            self.problem.validate_source(x)
            M = int(x.n_rows)
            fit_kw["device"] = self.device
        else:
            if y is None:
                raise ValueError(
                    "fit(x) needs the labels y, unless x is a "
                    "ShardedSource (which carries its own labels)")
            loader_kw = [k for k in ("depth", "executor", "metrics",
                                     "accountant") if k in fit_kw]
            if loader_kw:
                raise ValueError(
                    f"{'/'.join(loader_kw)} are streaming loader knobs — "
                    f"they only apply to fit(source); a dense fit has no "
                    f"prefetch loader to configure")
            x, y = self.problem.validate(x, y, self.device)
            M = int(x.shape[0])
        entry = registry.resolve(self.problem, M, mesh=self.mesh,
                                 route=self.route, cfg=self.cfg,
                                 streaming=streaming)
        instrumented = self.STREAM_INSTRUMENTED_ROUTES if streaming \
            else self.INSTRUMENTED_ROUTES
        if entry.name not in instrumented:
            bad = [n for n, v in (("resume", resume), ("faults", faults))
                   if v is not None]
            if bad:
                raise ValueError(
                    f"route {entry.name!r} has no {'/'.join(bad)} seam — "
                    f"instrumented routes: {list(instrumented)}")
        if resume is not None:
            fit_kw["resume"] = self._resume_manager(entry.name, resume, x, y,
                                                    key, faults, streaming)
        if faults is not None:
            fit_kw["faults"] = faults
        if tracker is not None:
            fit_kw["tracker"] = tracker
        # the schedule upgrade applies to an AUTO dsvrg dispatch only (an
        # explicit choice keeps whatever cfg.dsvrg says)
        auto = (entry.name == "dsvrg" and self.route is None
                and self.cfg.engine != "dsvrg")
        t0 = time.perf_counter()
        with trace_ctx(trace_dir), profile_ctx(profile_dir, self.device), \
                span("fit", route=entry.name, n_train=M,
                     device=str(self.device), streaming=streaming):
            with span(f"route.{entry.name}", engine=self.cfg.engine):
                out = entry.fit(self.problem, x, y, key, cfg=self.cfg,
                                mesh=self.mesh, data_axis=self.data_axis,
                                auto=auto, compile_kw=dict(self.compile_kw),
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

    def _resume_manager(self, route: str, resume, x, y: Tensor | None,
                        key, faults, streaming: bool = False):
        """The route's resume manager, fingerprinting THIS fit's (kernel,
        params, cfg, data, key) so a stale directory is rejected instead
        of splicing foreign duals into the solve. A streaming fit
        fingerprints the source (``source.fingerprint()``) instead of
        summing rows nobody holds."""
        from repro_torch.distributed import resume as resume_mod
        rc = resume_mod.ResumeConfig.of(resume)
        if streaming:
            prov = resume_mod.provenance_source(self.problem.kernel,
                                                self.problem.params,
                                                self.cfg, x, key)
        else:
            prov = resume_mod.provenance(self.problem.kernel,
                                         self.problem.params, self.cfg, x,
                                         y, key)
        cls = (resume_mod.DsvrgResumeManager if route == "dsvrg"
               else resume_mod.CascadeResumeManager)
        return cls(rc, prov, faults=faults)

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

    # -- persistence --------------------------------------------------------

    def save(self, directory: str) -> str:
        """Persist the fitted artifact (atomic versioned checkpoint, the
        reference's layout)."""
        return self._fitted().save(directory)

    @classmethod
    def load(cls, directory: str, *, problem: ProblemSpec | None = None,
             device: str | torch.device | None = None) -> "ODMEstimator":
        """Restore an estimator that scores at once (no refit), from an
        artifact either package saved, onto ``device`` (None: the card).
        The artifact stores the kernel spec, not the training
        hyperparameters: pass ``problem`` to set them for a later refit."""
        dev = resolve_device(device)
        model = serve_model.load_model(directory, device=dev)
        est = cls(problem if problem is not None
                  else ProblemSpec(kernel=model.spec), device=dev)
        est.model_ = model
        return est
