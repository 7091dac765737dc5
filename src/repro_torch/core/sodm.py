"""SODM Algorithm 1 — hierarchical partitioned ODM solve with warm starts.

Port of the single-process half of ``repro.core.sodm``. Level l has
K_l = p^l partitions of size m_l = M / K_l; each partition's local ODM
dual is solved by a level engine (:mod:`repro_torch.core.engines`); when
p siblings merge, their duals are concatenated as the parent's warm start
(Algorithm 1 line 12), zeta with zeta and beta with beta
(:func:`merge_alphas`). The engines rescale that warm start along its ray
first: children solved at scale m_l, the parent solves at p·m_l.

Linear-kernel problems may instead take the whole-problem DSVRG route
(Algorithm 2, :func:`_solve_dsvrg`) under the registry's dispatch rule.
The multi-device solve (``_solve_sharded``, ROADMAP A13) and the fault and
resume seams (A12) are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from repro_torch.core import dsvrg as dsvrg_mod
from repro_torch.core import engines, kernel_fns as kf
from repro_torch.core import odm as odm_mod
from repro_torch.core import partition as part_mod
from repro_torch.core.dsvrg import DSVRGConfig
from repro_torch.core.odm import ODMParams
from repro_torch.observe.spans import span as _span

Tensor = torch.Tensor


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
    partition_strategy: str = "stratified"   # stratified | random | identity
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
                 params: ODMParams, cfg: SODMConfig, key=None, *,
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
    """
    del spec
    from repro_torch.api import registry
    M = x.shape[0]
    K = registry.dsvrg_partition_count(M, cfg.dsvrg.n_partitions)
    dcfg = dataclasses.replace(cfg.dsvrg, n_partitions=K)
    if cfg.partition_strategy in ("stratified", "random"):
        dcfg = dataclasses.replace(
            dcfg, partition_strategy=cfg.partition_strategy,
            n_landmarks=cfg.n_landmarks)
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
                ) -> SODMResult:
    """The Algorithm-1 level loop: ``run_level(xs, ys, alphas, K) ->
    (alphas, sweeps, kkts)`` per level, then merge p siblings.

    ``tracker`` (anything with ``log_metrics(step, dict)``) receives
    per-level KKT / sweeps / SV count / throughput. ``faults`` and
    ``resume`` are not ported yet (ROADMAP A12).
    """
    if faults is not None or resume is not None:
        raise NotImplementedError(
            "faults/resume seams are not ported yet (ROADMAP A12)")
    M = x.shape[0]
    K = cfg.p ** cfg.levels
    m = M // K
    alphas = torch.zeros(K, 2 * m, dtype=x.dtype, device=x.device)
    sweeps_per_level: list[int] = []
    kkt = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    level = cfg.levels
    xp, yp = x[perm], y[perm]

    while True:
        t0 = time.perf_counter()
        with _span("cascade.level", level=level, K=K, m=m):
            alphas, sweeps, kkts = run_level(xp.reshape(K, m, -1),
                                             yp.reshape(K, m), alphas, K)
            sweeps_per_level.append(int(torch.max(sweeps)))
            kkt = torch.max(kkts)
        if tracker is not None:
            wall = time.perf_counter() - t0
            sv = int(torch.sum(torch.abs(alphas[:, :m] - alphas[:, m:]) > 0))
            tracker.log_metrics(len(sweeps_per_level), {
                "route": "sodm", "level": level, "K": K, "m": m,
                "sweeps": sweeps_per_level[-1], "kkt": float(kkt),
                "sv_count": sv, "wall_s": wall,
                "rows_per_s": M / max(wall, 1e-9)})
        if level_callback is not None:
            level_callback(level, alphas)
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
        raise NotImplementedError(
            "cluster partitions are not ported yet (ROADMAP A10)")
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


def _solve_sharded(*args, **kwargs) -> SODMResult:
    raise NotImplementedError(
        "the multi-device SODM solve is not ported yet (ROADMAP A13)")
