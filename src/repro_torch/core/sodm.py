"""SODM Algorithm 1 — hierarchical partitioned ODM solve with warm starts.

Port of ``repro.core.sodm``. Level l has
K_l = p^l partitions of size m_l = M / K_l; each partition's local ODM
dual is solved by a level engine (:mod:`repro_torch.core.engines`); when
p siblings merge, their duals are concatenated as the parent's warm start
(Algorithm 1 line 12), zeta with zeta and beta with beta
(:func:`merge_alphas`). The engines rescale that warm start along its ray
first: children solved at scale m_l, the parent solves at p·m_l.

Linear-kernel problems may instead take the whole-problem DSVRG route
(Algorithm 2, :func:`_solve_dsvrg`) under the registry's dispatch rule.
The level loop carries the reference's seams: a fault plan's
``cascade.level`` site before each level solve, a resume manager's
checkpoint after it, and re-entry at the first unsolved level of a
resume directory (:mod:`repro_torch.distributed.resume`);
:func:`level_solve_count` counts the solves actually run.

Two execution layouts, as in the reference:

* :func:`_solve` — one process: all partitions of a level advance
  together on one device.
* :func:`_solve_sharded` — SPMD over the ``data`` axis of a
  ``torch.distributed`` device mesh (:mod:`repro_torch.sharding`). Every
  rank calls it with the same arguments. The partition permutation is
  drawn once, on the mesh's first rank, and broadcast. While
  K_l >= n_dev (and divides by it) each rank solves its contiguous slab
  of K_l / n_dev partitions with the same level engine — the only device
  work of the level is its own slab's, and its slab alone is moved to
  its device — and one tiled all-gather (:func:`repro_torch.sharding
  .all_gather`) hands every rank the level's duals, sweeps and KKTs, so
  the loop's ``max(sweeps)`` / ``max(kkts)`` see every partition (the
  reference's ``out_specs=P(data_axis)``). Once K_l < n_dev the residual
  levels run replicated on every rank. A rank's slab stops on its own
  partitions' KKT, so a sharded fit is not bit for bit the one-process
  fit at n_dev > 1 (nor is the reference's); at n_dev = 1 every level
  takes the replicated branch and equals it bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from repro_torch import sharding as shd
from repro_torch.analysis.invariants import counter as _counter
from repro_torch.core import dsvrg as dsvrg_mod
from repro_torch.core import engines, kernel_fns as kf
from repro_torch.core import odm as odm_mod
from repro_torch.core import partition as part_mod
from repro_torch.core.dsvrg import DSVRGConfig
from repro_torch.core.odm import ODMParams
from repro_torch.observe.spans import span as _span

Tensor = torch.Tensor

# one per level solve actually run (restored levels do not count); a
# resumed fit's delta is smaller than a cold restart's
_LEVEL_SOLVES = _counter("sodm.level_solve")


def level_solve_count() -> int:
    """How many level solves have run in this process — resumed fits skip
    their restored levels."""
    return _LEVEL_SOLVES.count


@dataclasses.dataclass(frozen=True)
class SODMConfig:
    """Hyperparameters of the SODM solve (the reference's fields and
    defaults)."""

    p: int = 2                 # merge factor (partitions merged per level)
    levels: int = 3            # L: start with p^L partitions
    n_landmarks: int = 8       # S strata
    tol: float = 1e-4          # per-solve KKT tolerance
    max_sweeps: int = 100      # CD sweep / outer-pass cap per local solve
    early_stop: bool = True    # Algorithm 1 line 5-6
    partition_strategy: str = "stratified"   # stratified | random |
    #                                          cluster | identity
    engine: str | None = None  # None (auto) | scalar | block | pallas | dsvrg
    block: int = 256           # tile size of the block/pallas engines
    gram_threshold: int = 4096  # pallas: partitions above this rebuild Gram
    #                             tiles from features (O(m·B) memory)
    adaptive: bool = True      # pallas: in-tile early exit at 0.01*tol
    dsvrg: DSVRGConfig = DSVRGConfig(epochs=10, batch=64)
    dsvrg_threshold: int = 200_000  # linear-kernel auto-route threshold


class SODMResult(NamedTuple):
    alpha: Tensor            # (2M,) global-layout dual solution
    perm: Tensor             # (M,) partition permutation applied to the data
    levels_run: int
    sweeps_per_level: list   # python list of int sweep counts
    kkt: Tensor              # final level's worst KKT residual


def merge_alphas(alphas: Tensor) -> Tensor:
    """(..., K, 2m) per-partition [zeta;beta] -> (..., 2Km) global
    [zeta_all; beta_all]."""
    K, two_m = alphas.shape[-2:]
    m = two_m // 2
    lead = alphas.shape[:-2]
    zetas = alphas[..., :m].reshape(*lead, K * m)
    betas = alphas[..., m:].reshape(*lead, K * m)
    return torch.cat([zetas, betas], dim=-1)


def split_to_partitions(alpha: Tensor, K: int) -> Tensor:
    """Inverse of merge_alphas: (2M,) -> (K, 2m)."""
    M = alpha.shape[0] // 2
    m = M // K
    return torch.cat([alpha[:M].reshape(K, m), alpha[M:].reshape(K, m)],
                     dim=1)


def _solve_dsvrg(spec: kf.KernelSpec, x: Tensor, y: Tensor,
                 params: ODMParams, cfg: SODMConfig, key=None, mesh=None,
                 data_axis: str = "data", auto: bool = False, *,
                 faults=None, tracker=None, resume=None,
                 ) -> tuple[SODMResult, dsvrg_mod.DSVRGResult]:
    """Whole-problem linear-kernel route (the registry's dsvrg entry).

    Solves the primal with DSVRG (Algorithm 2) and recovers the dual with
    ``odm.alpha_from_w``; the native ``DSVRGResult`` comes back alongside
    for the report (history, eta) and the artifact (the primal ``w``).
    ``levels_run`` is 1, ``sweeps_per_level`` the epoch count, and ``kkt``
    the primal stationarity residual max|w − w_from_alpha(alpha)|. The
    partition count is clamped to one that divides M; the outer
    ``partition_strategy``/``n_landmarks`` carry over for the strategies
    DSVRG has (stratified, random). The solve is epoch-budgeted:
    ``tol``/``max_sweeps`` are level-loop knobs and do not apply.

    On a ``mesh`` the solve is :func:`repro_torch.core.dsvrg
    ._solve_sharded` over ``mesh[data_axis]``, with K a multiple of the
    axis size. An AUTO-dispatched solve on a mesh (``auto=True``) runs the
    ``"parallel"`` schedule: the serial chain is replicated compute over a
    gathered slab, wrong for the big-data regime that triggers the auto
    route. An explicit ``engine="dsvrg"`` keeps ``cfg.dsvrg``'s schedule.
    The dual is recovered from w on every rank (replicated).
    """
    del spec
    from repro_torch.api import registry
    M = x.shape[0]
    n_dev = shd.axis_size(mesh, data_axis) if mesh is not None else 1
    K = registry.dsvrg_partition_count(M, cfg.dsvrg.n_partitions, n_dev)
    dcfg = dataclasses.replace(cfg.dsvrg, n_partitions=K)
    if auto and mesh is not None:
        dcfg = dataclasses.replace(dcfg, schedule="parallel")
    if cfg.partition_strategy in ("stratified", "random"):
        dcfg = dataclasses.replace(
            dcfg, partition_strategy=cfg.partition_strategy,
            n_landmarks=cfg.n_landmarks)
    if mesh is not None:
        res = dsvrg_mod._solve_sharded(x, y, params, dcfg, key, mesh,
                                       data_axis=data_axis, faults=faults,
                                       tracker=tracker, resume=resume)
        x, y = x.to(res.w.device), y.to(res.w.device)
    else:
        res = dsvrg_mod._solve(x, y, params, dcfg, key, faults=faults,
                               tracker=tracker, resume=resume)
    xp, yp = x[res.perm], y[res.perm]
    alpha = odm_mod.alpha_from_w(res.w, xp, yp, params)
    # grad p(w) = w − w_from_alpha(alpha_from_w(w)) exactly, so the
    # stationarity residual reuses the alpha pass
    kkt = torch.max(torch.abs(res.w - odm_mod.w_from_alpha(xp, yp, alpha)))
    return SODMResult(alpha=alpha, perm=res.perm, levels_run=1,
                      sweeps_per_level=[dcfg.epochs], kkt=kkt), res


def _level_loop(run_level, x: Tensor, y: Tensor, perm: Tensor,
                cfg: SODMConfig, *, faults=None, tracker=None, resume=None,
                level_callback: Callable[[int, Tensor], None] | None = None,
                device: torch.device | None = None) -> SODMResult:
    """The Algorithm-1 level loop: ``run_level(xs, ys, alphas, K) ->
    (alphas, sweeps, kkts)`` per level, then merge p siblings.

    Instrumentation seams, all default-off:

    * ``faults`` — a :class:`repro_torch.distributed.faults.FaultPlan`;
      the ``"cascade.level"`` site fires BEFORE each level solve, so a kill
      at level k leaves level k+1's checkpoint as the last committed state.
    * ``tracker`` (anything with ``log_metrics(step, dict)``) — per-level
      KKT / sweeps / SV count / throughput.
    * ``resume`` — a :class:`repro_torch.distributed.resume
      .CascadeResumeManager`; every solved level is checkpointed, and a
      non-empty resume directory re-enters the loop at the first unsolved
      level with the restored ``perm``, duals, sweeps and KKT (the
      restored level counts as solved: straight to the convergence check
      and the merge). Level solves are deterministic on either device and
      the checkpoint round trip is exact, so the resumed result equals an
      uninterrupted run's bit for bit.

    The duals live on ``device`` (default: the device of ``x``; the
    sharded driver may leave the data on the host and move slabs).
    """
    device = x.device if device is None else device
    restored = resume.restore(device=device) if resume is not None \
        else None
    M = x.shape[0]
    if restored is not None:
        level, K, m = restored.level, restored.K, restored.m
        alphas, perm = restored.alphas, restored.perm
        sweeps_per_level = list(restored.sweeps_per_level)
        kkt = restored.kkt
        pending = False          # the restored level is already solved
    else:
        K = cfg.p ** cfg.levels
        m = M // K
        alphas = torch.zeros(K, 2 * m, dtype=x.dtype, device=device)
        sweeps_per_level = []
        kkt = torch.tensor(float("inf"), dtype=x.dtype, device=device)
        level = cfg.levels
        pending = True
    xp, yp = x[perm.to(x.device)], y[perm.to(x.device)]

    while True:
        if pending:
            if faults is not None:
                faults.site("cascade.level", level=level, K=K)
            _LEVEL_SOLVES.bump()
            t0 = time.perf_counter()
            with _span("cascade.level", level=level, K=K, m=m):
                alphas, sweeps, kkts = run_level(xp.reshape(K, m, -1),
                                                 yp.reshape(K, m), alphas, K)
                sweeps_per_level.append(int(torch.max(sweeps)))
                kkt = torch.max(kkts)
            if tracker is not None:
                wall = time.perf_counter() - t0
                sv = int(torch.sum(
                    torch.abs(alphas[:, :m] - alphas[:, m:]) > 0))
                tracker.log_metrics(len(sweeps_per_level), {
                    "route": "sodm", "level": level, "K": K, "m": m,
                    "sweeps": sweeps_per_level[-1], "kkt": float(kkt),
                    "sv_count": sv, "wall_s": wall,
                    "rows_per_s": M / max(wall, 1e-9)})
            if resume is not None:
                resume.save_level(level=level, K=K, m=m, alphas=alphas,
                                  perm=perm,
                                  sweeps_per_level=sweeps_per_level,
                                  kkt=kkt)
            if level_callback is not None:
                level_callback(level, alphas)
        pending = True
        # Algorithm 1 line 5: a level whose warm start was already within
        # tol everywhere (0 sweeps) ends the cascade
        converged = cfg.early_stop and sweeps_per_level[-1] == 0 \
            and level < cfg.levels
        if K == 1 or level == 0 or converged:
            break
        Kn = K // cfg.p
        alphas = merge_alphas(alphas.reshape(Kn, cfg.p, 2 * m))
        K, m = Kn, m * cfg.p
        level -= 1

    alpha = merge_alphas(alphas) if alphas.shape[0] > 1 \
        else alphas.reshape(-1)
    return SODMResult(alpha=alpha, perm=perm,
                      levels_run=len(sweeps_per_level),
                      sweeps_per_level=sweeps_per_level, kkt=kkt)


def _partition(spec: kf.KernelSpec, x: Tensor, cfg: SODMConfig, K0: int,
               key) -> Tensor:
    M = x.shape[0]
    if cfg.partition_strategy == "stratified":
        return part_mod.make_plan(spec, x, cfg.n_landmarks, K0, key).perm
    if cfg.partition_strategy == "random":
        return part_mod.random_partitions(M, K0, key, device=x.device)
    if cfg.partition_strategy == "identity":
        return torch.arange(M, device=x.device)  # caller laid the data out
    if cfg.partition_strategy == "cluster":
        return part_mod.cluster_partitions(spec, x, K0, key)
    raise ValueError(cfg.partition_strategy)


def _solve(spec: kf.KernelSpec, x: Tensor, y: Tensor, params: ODMParams,
           cfg: SODMConfig, key=None,
           level_callback: Callable[[int, Tensor], None] | None = None,
           *, faults=None, tracker=None, resume=None) -> SODMResult:
    """Single-process Algorithm 1 on the device of ``x``. ``key`` is a
    ``torch.Generator`` or an int seed (the reference's PRNG key)."""
    from repro_torch.api import registry
    M = x.shape[0]
    if registry.resolve_auto(spec.name, M, engine=cfg.engine,
                             threshold=cfg.dsvrg_threshold).name == "dsvrg":
        return _solve_dsvrg(spec, x, y, params, cfg, key, faults=faults,
                            tracker=tracker, resume=resume)[0]
    K0 = cfg.p ** cfg.levels
    if M % K0 != 0:
        raise ValueError(f"p^L={K0} must divide M={M}")
    perm = _partition(spec, x, cfg, K0, key)
    solver = engines.make_local_solver(cfg.engine, block=cfg.block,
                                       gram_threshold=cfg.gram_threshold,
                                       adaptive=cfg.adaptive)

    def run_level(xs, ys, alphas, K):
        del K
        return solver(xs, ys, alphas, spec=spec, params=params, tol=cfg.tol,
                      max_sweeps=cfg.max_sweeps)

    return _level_loop(run_level, x, y, perm, cfg, faults=faults,
                       tracker=tracker, resume=resume,
                       level_callback=level_callback)


# ---------------------------------------------------------------------------
# SPMD: partitions sharded over the mesh's data axis
# ---------------------------------------------------------------------------

def _sharded_perm(spec: kf.KernelSpec, x: Tensor, cfg: SODMConfig, K0: int,
                  key) -> Tensor:
    """The reference's sharded partitioning: stratified, or random for
    every other strategy (``src/repro/core/sodm.py:414-418``)."""
    if cfg.partition_strategy == "stratified":
        return part_mod.make_plan(spec, x, cfg.n_landmarks, K0, key).perm
    return part_mod.random_partitions(x.shape[0], K0, key, device=x.device)


def _solve_sharded(spec: kf.KernelSpec, x: Tensor, y: Tensor,
                   params: ODMParams, cfg: SODMConfig, key, mesh,
                   data_axis: str = "data", *, faults=None, tracker=None,
                   resume=None) -> SODMResult:
    """Algorithm 1 with partitions sharded over ``mesh[data_axis]`` (the
    module docs). Every rank of the mesh calls it with the same arguments
    and returns the same result, on its own device. Preconditions: p^L
    partitions with p^L % n_dev == 0. Linear problems that resolve to
    DSVRG take the sharded DSVRG route (an AUTO dispatch upgrades it to
    the parallel schedule). ``faults``, ``tracker`` and ``resume`` behave
    as in :func:`_solve`; a resume manager checkpoints from the mesh's
    first rank only (:meth:`repro_torch.distributed.resume._Manager
    .bind`)."""
    from repro_torch.api import registry
    M = x.shape[0]
    if registry.resolve_auto(spec.name, M, engine=cfg.engine,
                             threshold=cfg.dsvrg_threshold).name == "dsvrg":
        return _solve_dsvrg(spec, x, y, params, cfg, key, mesh=mesh,
                            data_axis=data_axis,
                            auto=cfg.engine != "dsvrg", faults=faults,
                            tracker=tracker, resume=resume)[0]
    K0 = cfg.p ** cfg.levels
    n_dev = shd.axis_size(mesh, data_axis)
    if K0 % n_dev != 0:
        raise ValueError(f"p^L={K0} must be a multiple of data axis {n_dev}")
    if M % K0 != 0:
        raise ValueError(f"p^L={K0} must divide M={M}")
    dev = shd.mesh_device(mesh)
    # one permutation for the whole mesh: drawn on the first rank only
    if shd.is_mesh_rank0(mesh):
        perm = _sharded_perm(spec, x, cfg, K0, key).to(dev, torch.int64)
    else:
        perm = torch.empty(M, dtype=torch.int64, device=dev)
    perm = shd.broadcast(perm, mesh)
    if resume is not None:
        resume.bind(mesh)
    solver = engines.make_local_solver(cfg.engine, block=cfg.block,
                                       gram_threshold=cfg.gram_threshold,
                                       adaptive=cfg.adaptive)
    r = shd.axis_index(mesh, data_axis)

    def run_level(xs, ys, alphas, K):
        kw = dict(spec=spec, params=params, tol=cfg.tol,
                  max_sweeps=cfg.max_sweeps)
        if not (K >= n_dev and K % n_dev == 0 and n_dev > 1):
            # the replicated tail (K < n_dev: one in-memory QP by now)
            return solver(xs.to(dev), ys.to(dev), alphas, **kw)
        # this rank's slab of partitions, then one gather of its duals,
        # sweeps and KKTs (packed as fp32 rows, exact for counts < 2^24)
        lo, hi = r * (K // n_dev), (r + 1) * (K // n_dev)
        a, sweeps, kkts = solver(xs[lo:hi].to(dev), ys[lo:hi].to(dev),
                                 alphas[lo:hi], **kw)
        packed = torch.cat([a, sweeps.to(a.dtype)[:, None],
                            kkts.to(a.dtype)[:, None]], dim=1)
        full = shd.all_gather(packed, mesh, data_axis)
        return full[:, :-2], full[:, -2].to(torch.int32), full[:, -1]

    return _level_loop(run_level, x, y, perm, cfg, faults=faults,
                       tracker=tracker, resume=resume, device=dev)
