"""Evaluate the paper's Theorem 1 / Theorem 2 bounds on concrete problems.

Port of ``repro.core.theory``. The theorems must hold for any valid
inputs, and stratified partitions should leave a smaller Q-bar (the
cross-partition kernel mass) than random or cluster partitions: the
mechanism behind the paper's speedup. Every Gram goes through
``ops.gram`` (B8 on the card) and every exact solve through
``dual_cd.solve`` (K4 on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import dual_cd, kernel_fns as kf
from repro_torch.core.odm import ODMParams, dual_objective
from repro_torch.kernels import ops

Tensor = torch.Tensor


class Theorem1Eval(NamedTuple):
    gap_objective: Tensor     # d(zeta~*, beta~*) - d(zeta*, beta*)
    gap_solution: Tensor      # ||alpha~* - alpha*||^2
    bound_objective: Tensor   # U^2 (Qbar + M (M - m) c)
    bound_solution: Tensor    # U^2/(M c v) (Qbar + M (M - m) c)
    holds: Tensor             # both inequalities satisfied (with fp slack)


def _cross(M: int, m: int, device) -> Tensor:
    pid = torch.arange(M, device=device) // m
    return pid[:, None] != pid[None, :]


def solve_global_and_blockwise(spec: kf.KernelSpec, x: Tensor, y: Tensor,
                               params: ODMParams, n_partitions: int,
                               tol: float = 1e-7, max_sweeps: int = 2000):
    """Optimal alpha of the global dual and of its block-diagonal
    approximation (Eqn. 4). The data must already be in partition order.
    Returns (Q, Q_blockdiag, alpha_global, alpha_blockwise)."""
    M = x.shape[0]
    m = M // n_partitions
    Q = ops.gram(x, None, spec, yx=y)
    res_g = dual_cd.solve(Q, params, mscale=float(M), tol=tol,
                          max_sweeps=max_sweeps)
    # the block-diagonal problem: K decoupled local solves at mscale m
    Qt = Q * (~_cross(M, m, x.device)).to(Q.dtype)
    res_b = dual_cd.solve(Qt, params, mscale=float(m), tol=tol,
                          max_sweeps=max_sweeps)
    return Q, Qt, res_g.alpha, res_b.alpha


def eval_theorem1(spec: kf.KernelSpec, x: Tensor, y: Tensor,
                  params: ODMParams, n_partitions: int,
                  tol: float = 1e-7) -> Theorem1Eval:
    M = x.shape[0]
    m = M // n_partitions
    Q, _, a_g, a_b = solve_global_and_blockwise(spec, x, y, params,
                                                n_partitions, tol=tol)
    d_g = dual_objective(Q, a_g, params, float(M))
    d_b = dual_objective(Q, a_b, params, float(M))   # d() at the approx
    gap_obj = d_b - d_g
    gap_sol = torch.sum((a_b - a_g) ** 2)

    U = torch.maximum(torch.max(torch.abs(a_g)), torch.max(torch.abs(a_b)))
    Qbar = torch.sum(torch.where(_cross(M, m, x.device), torch.abs(Q), 0.0))
    c = params.c
    bound_obj = U ** 2 * (Qbar + M * (M - m) * c)
    bound_sol = U ** 2 / (M * c * params.ups) * (Qbar + M * (M - m) * c)
    slack = 1e-6 + 1e-5 * torch.abs(bound_obj)
    holds = (gap_obj >= -slack) & (gap_obj <= bound_obj + slack) \
        & (gap_sol <= bound_sol + slack)
    return Theorem1Eval(gap_objective=gap_obj, gap_solution=gap_sol,
                        bound_objective=bound_obj, bound_solution=bound_sol,
                        holds=holds)


class Theorem2Eval(NamedTuple):
    gap: Tensor              # d_k(local) - d(global) for the worst k
    bound: Tensor
    cos_tau: Tensor
    holds: Tensor


def eval_theorem2(spec: kf.KernelSpec, x: Tensor, y: Tensor,
                  params: ODMParams, stratum: Tensor, n_partitions: int,
                  perm: Tensor, tol: float = 1e-7) -> Theorem2Eval:
    """The Theorem-2 upper bound for the stratified partitions ``perm``.
    Needs a shift-invariant kernel (r² = kappa(0); ``spec.diag_value()``
    raises otherwise)."""
    r2 = spec.diag_value()
    M = x.shape[0]
    m = M // n_partitions
    xp, yp = x[perm], y[perm]
    Q = ops.gram(xp, None, spec, yx=yp)
    res_g = dual_cd.solve(Q, params, mscale=float(M), tol=tol,
                          max_sweeps=2000)
    d_g = dual_objective(Q, res_g.alpha, params, float(M))

    # the worst local objective (each local solve at mscale m)
    worst = torch.tensor(-torch.inf, dtype=x.dtype, device=x.device)
    U = torch.max(torch.abs(res_g.alpha))
    for k in range(n_partitions):
        Qk = Q[k * m:(k + 1) * m, k * m:(k + 1) * m].contiguous()
        res_k = dual_cd.solve(Qk, params, mscale=float(m), tol=tol,
                              max_sweeps=2000)
        d_k = dual_objective(Qk, res_k.alpha, params, float(m))
        worst = torch.maximum(worst, d_k - d_g)
        U = torch.maximum(U, torch.max(torch.abs(res_k.alpha)))

    cos_tau = part_cos_tau(spec, x, stratum)
    C = torch.sum((stratum[:, None] != stratum[None, :]).to(torch.float32))
    c = params.c
    bound = (U ** 2 / 2.0 * (M ** 2 * r2 + r2 * cos_tau * (2.0 * C - M ** 2))
             + U ** 2 * M ** 2 * c + 2.0 * U * M)
    slack = 1e-6 + 1e-5 * torch.abs(bound)
    return Theorem2Eval(gap=worst, bound=bound, cos_tau=cos_tau,
                        holds=worst <= bound + slack)


def part_cos_tau(spec: kf.KernelSpec, x: Tensor, stratum: Tensor) -> Tensor:
    """cos of the minimal principal angle across strata (Theorem 2's
    tau), with K through ``ops.gram``."""
    K = ops.gram(x, None, spec)
    diag = torch.sqrt(torch.clamp_min(kf.gram_diag(spec, x), 1e-12))
    Kn = K / (diag[:, None] * diag[None, :])
    cross = stratum[:, None] != stratum[None, :]
    return torch.max(torch.where(cross, Kn, -torch.inf))
