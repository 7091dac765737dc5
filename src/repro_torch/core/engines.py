"""Pluggable solver engines for SODM level solves.

Port of ``repro.core.engines``. Every level of Algorithm 1 is K
independent partition-local ODM duals of identical size; a level solver
maps

    (xs (K, m, d), ys (K, m), alphas (K, 2m))
        -> (alphas' (K, 2m), sweeps (K,), kkts (K,))

``sweeps`` counts CD sweeps (scalar) or outer Jacobi passes (block
engines); a warm start already within tol reports 0, which Algorithm 1
line 5's early stop reads. Every engine first rescales merged warm starts
along the ray (:func:`repro_torch.core.odm.warm_start_scale`).

* ``"scalar"`` — exact Gauss-Seidel CD per partition (the paper's). On
  the card the level's K signed Grams take one B8 launch (``ops.gram``)
  and its K solves one K4 launch (``dual_cd.solve``).
* ``"block"``  — block-Gauss-Seidel, the plain oracle of the tile path.
* ``"pallas"`` — greedy block CD through the hand-written kernels
  (:mod:`repro_torch.kernels.dual_cd_block`; the name is kept from the
  reference so one ``SODMConfig`` drives both packages). Partitions above
  ``gram_threshold`` rebuild off-diagonal Gram tiles from the features
  (O(m·B) memory) for every kernel family. A level's Grams (its diagonal
  tiles, or its dense padded Q) take one :func:`ops.gram` call: B8 on the
  card, its plain version on the CPU. The reference builds the same
  Grams with ``vmap(kf.signed_gram)``, which computes the same function.

``"dsvrg"`` is a whole-problem route, not a level solver:
``sodm._solve`` dispatches it before the level loop
(:mod:`repro_torch.core.dsvrg`).
"""
from __future__ import annotations

from typing import Protocol

import torch

from repro_torch.core import dual_cd, kernel_fns as kf
from repro_torch.core import odm
from repro_torch.core.odm import ODMParams
from repro_torch.kernels import dual_cd_block as cdk
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels import ops

Tensor = torch.Tensor

LEVEL_ENGINES = ("scalar", "block", "pallas")
ENGINES = LEVEL_ENGINES + ("dsvrg",)


def _rescale_warm_start(Q: Tensor, ak: Tensor, params: ODMParams,
                        m: int) -> tuple[Tensor, Tensor]:
    """Exact line search along the warm-start ray, batched over
    partitions: Q (K, m, m), ak (K, 2m). Returns the rescaled alpha and
    its cache u = Q (zeta - beta) (u is linear in alpha, so the matvec
    paid here goes to the solver)."""
    zeta, beta = odm.split_alpha(ak)
    u = torch.einsum("kij,kj->ki", Q, zeta - beta)
    t = odm.warm_start_scale(u, ak, params, float(m))[:, None]
    return ak * t, u * t


class LocalSolver(Protocol):
    """Solves all K local ODM duals of one SODM level."""

    def __call__(self, xs: Tensor, ys: Tensor, alphas: Tensor, *,
                 spec: kf.KernelSpec, params: ODMParams, tol: float,
                 max_sweeps: int) -> tuple[Tensor, Tensor, Tensor]:
        ...


def solve_level_scalar(xs: Tensor, ys: Tensor, alphas: Tensor, *,
                       spec: kf.KernelSpec, params: ODMParams, tol: float,
                       max_sweeps: int) -> tuple[Tensor, Tensor, Tensor]:
    m = xs.shape[1]
    Q = ops.gram(xs, None, spec, yx=ys)
    ak, uk = _rescale_warm_start(Q, alphas, params, m)
    res = dual_cd.solve(Q, params, mscale=float(m), alpha0=ak, tol=tol,
                        max_sweeps=max_sweeps, u0=uk)
    return res.alpha, res.sweeps, res.kkt


def solve_level_block(xs: Tensor, ys: Tensor, alphas: Tensor, *,
                      spec: kf.KernelSpec, params: ODMParams, tol: float,
                      max_sweeps: int,
                      block: int = 256) -> tuple[Tensor, Tensor, Tensor]:
    m = xs.shape[1]
    Q = kf.signed_gram(spec, xs, ys)
    ak, uk = _rescale_warm_start(Q, alphas, params, m)
    res = dual_cd.solve_block(Q, params, mscale=float(m), block=min(block, m),
                              alpha0=ak, tol=tol, max_outer=max_sweeps,
                              u0=uk)
    return res.alpha, res.sweeps, res.kkt


def diag_blocks(spec: kf.KernelSpec, xp: Tensor, yp: Tensor,
                B: int) -> Tensor:
    """The signed diagonal Gram tiles (K, nblk, B, B) of row-padded
    partitions xp (K, nblk·B, d) with labels yp (K, nblk·B), 0 on padded
    rows (so padded rows and columns come out 0): one :func:`ops.gram`
    over the (K·nblk, B, d) reshape."""
    K, mp, d = xp.shape
    nblk = mp // B
    qb = ops.gram(xp.reshape(K * nblk, B, d), None, spec,
                  yx=yp.reshape(K * nblk, B))
    return qb.reshape(K, nblk, B, B)


def solve_level_pallas(xs: Tensor, ys: Tensor, alphas: Tensor, *,
                       spec: kf.KernelSpec, params: ODMParams, tol: float,
                       max_sweeps: int, block: int = 256,
                       gram_threshold: int = 4096,
                       adaptive: bool = True) -> tuple[Tensor, Tensor, Tensor]:
    K, m, _ = xs.shape
    B = min(block, m)
    nblk = -(-m // B)
    mp = nblk * B
    pad = mp - m
    valid = (torch.arange(mp, device=xs.device) < m).to(xs.dtype)

    xp = torch.nn.functional.pad(xs, (0, 0, 0, pad))
    # padded labels are 0 so the signed matvec y ⊙ (K @ (y ⊙ g)) zeroes
    # padded rows and columns without ever masking a Gram tile
    yp = torch.nn.functional.pad(ys, (0, pad))
    a0 = torch.cat([torch.nn.functional.pad(alphas[:, :m], (0, pad)),
                    torch.nn.functional.pad(alphas[:, m:], (0, pad))], dim=1)

    if m > gram_threshold:
        # diagonal Gram tiles only, (K, nblk, B, B): O(m·B) per partition
        qb = diag_blocks(spec, xp, yp, B)
        src = gram_mod.make_kernel_source(spec, xp, yp, bm=B)
    else:
        Qp = ops.gram(xp, None, spec, yx=yp)
        Qp = Qp * (valid[None, :, None] * valid[None, None, :])
        qb = cdk.extract_diag_blocks(Qp, B)
        src = gram_mod.DenseSource(Qp.contiguous())
    qb = qb.contiguous()

    # warm-start ray rescale, batched over partitions; the rescaled cache
    # rides along to the solver
    u0 = src.matvec(a0[:, :mp] - a0[:, mp:])
    t = odm.warm_start_scale(u0, a0, params, float(m))[:, None]
    a0 = a0 * t
    u0 = u0 * t

    out, kkts, passes = cdk.solve_level(
        qb, src, a0, c=params.c, ups=params.ups, theta=params.theta,
        mscale=float(m), n_passes=max_sweeps, tol=tol, valid=valid,
        us0=u0, adaptive=adaptive)
    alphas = torch.cat([out[:, :m], out[:, mp:mp + m]], dim=1)
    sweeps = torch.full((K,), passes, dtype=torch.int32, device=xs.device)
    return alphas, sweeps, kkts


def make_local_solver(engine: str | None = "scalar", block: int = 256,
                      gram_threshold: int = 4096,
                      adaptive: bool = True) -> LocalSolver:
    """Resolve an engine name (``SODMConfig.engine``) to a LocalSolver;
    ``None`` means the scalar level solver."""
    if engine is None:
        engine = "scalar"
    if engine == "scalar":
        return solve_level_scalar
    if engine == "block":
        def _block(xs, ys, alphas, *, spec, params, tol, max_sweeps):
            return solve_level_block(xs, ys, alphas, spec=spec,
                                     params=params, tol=tol,
                                     max_sweeps=max_sweeps, block=block)
        return _block
    if engine == "pallas":
        def _pallas(xs, ys, alphas, *, spec, params, tol, max_sweeps):
            return solve_level_pallas(xs, ys, alphas, spec=spec,
                                      params=params, tol=tol,
                                      max_sweeps=max_sweeps, block=block,
                                      gram_threshold=gram_threshold,
                                      adaptive=adaptive)
        return _pallas
    if engine == "dsvrg":
        raise ValueError(
            "engine='dsvrg' is a whole-problem primal solver, not a level "
            "solver — sodm._solve dispatches it before the level loop")
    raise ValueError(
        f"engine must be one of {LEVEL_ENGINES} (or 'dsvrg'/None at the "
        f"SODMConfig level), got {engine!r}")
