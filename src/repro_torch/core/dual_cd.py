"""Dual coordinate descent for the ODM box-constrained QP (Eqn. 3).

Port of ``repro.core.dual_cd``. The univariate subproblem for coordinate i
has the closed form ``alpha_i <- max(alpha_i - grad_i / H_ii, 0)``; the
cache ``u = Q (zeta - beta)`` makes each update O(m).

* :func:`solve` — exact Gauss-Seidel sweeps over the 2m coordinates. A
  CPU ``Q`` runs the plain version :func:`solve_plain` (a Python loop over
  the coordinates); a CUDA ``Q`` launches K4 (``csrc/cd_exact.cu``), which
  runs the whole solve — sweeps and the KKT stop — in one launch with no
  host read, in the plain version's arithmetic (counted in
  ``solve.launches``): one CTA a partition, one warp running the
  coordinate chain 32 steps at a time while the others apply each batch's
  updates to u.
* :func:`solve_block` — exact CD within each tile, Jacobi across tiles,
  with an exact line search per pass: the plain oracle of the greedy tile
  kernels in :mod:`repro_torch.kernels.dual_cd_block`.

Both take a signed Gram ``Q`` of shape (m, m) or a batch (K, m, m). A
batch advances all partitions together, and a partition that has
converged stops moving while the others go on — the semantics of the
reference's ``vmap`` over a ``while_loop``, so each partition reports its
own sweep count.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.invariants import counter as _counter
from repro_torch.core.odm import (ODMParams, dual_grad_from_u,
                                  dual_objective, projected_violation,
                                  split_alpha)
from repro_torch.kernels import _build
from repro_torch.kernels._device import on_cpu

Tensor = torch.Tensor


class CDResult(NamedTuple):
    alpha: Tensor       # (..., 2m) final dual variables
    u: Tensor           # (..., m) final cache Q (zeta - beta)
    sweeps: Tensor      # (...) int32 sweeps executed
    kkt: Tensor         # (...) final projected-gradient infinity norm


def kkt_from_u(u: Tensor, alpha: Tensor, params: ODMParams,
               mscale: float) -> Tensor:
    g = dual_grad_from_u(u, alpha, params, mscale)
    return torch.amax(projected_violation(g, alpha), dim=-1)


def _f32(v: float) -> float:
    """A Python float compared the way the reference compares it: cast to
    the solver's fp32."""
    return float(np.float32(v))


def _batched(Q: Tensor, alpha0: Tensor | None, u0: Tensor | None):
    single = Q.dim() == 2
    if single:
        Q = Q[None]
        alpha0 = None if alpha0 is None else alpha0[None]
        u0 = None if u0 is None else u0[None]
    return single, Q, alpha0, u0


def _unbatch(single: bool, res: CDResult) -> CDResult:
    return CDResult(*(t[0] for t in res)) if single else res


def _sweep(Q: Tensor, q_diag: Tensor, alpha: Tensor, u: Tensor,
           active: Tensor, params: ODMParams, mscale: float,
           moves: Tensor | None = None) -> None:
    """One Gauss-Seidel sweep over all 2m coordinates, in place, for the
    partitions marked ``active`` (the others get delta = 0); ``moves``
    (K,), when given, counts each partition's steps with delta != 0."""
    m = Q.shape[-1]
    cz = mscale * params.c * params.ups
    cb = mscale * params.c
    for i in range(2 * m):
        is_zeta = i < m
        row = i if is_zeta else i - m
        a_i = alpha[:, i]
        if is_zeta:
            g = u[:, row] + cz * a_i + (params.theta - 1.0)
            h = q_diag[:, row] + cz
        else:
            g = -u[:, row] + cb * a_i + (params.theta + 1.0)
            h = q_diag[:, row] + cb
        new = torch.clamp_min(a_i - g / h, 0.0)
        new = torch.where(active, new, a_i)
        delta = new - a_i
        if moves is not None:
            moves += delta != 0.0
        sign = 1.0 if is_zeta else -1.0
        u += (sign * delta)[:, None] * Q[:, :, row]
        alpha[:, i] = new


def _start(Q: Tensor, alpha0: Tensor | None,
           u0: Tensor | None) -> tuple[Tensor, Tensor]:
    """Fresh copies of the start: alpha (zeros by default) and its cache
    u = Q (zeta - beta), computed here when not given (zero for the
    zero start). One matvec a partition: a batched product sums in an
    order that depends on K on the card, and a partition's solve must not
    depend on how many others share its launch (the streamed cascade
    solves its nodes one at a time, the resident one a level at a
    time)."""
    K, m, _ = Q.shape
    if u0 is not None:
        u = u0.clone()
    elif alpha0 is None:
        u = torch.zeros(K, m, dtype=Q.dtype, device=Q.device)
    else:
        zeta, beta = split_alpha(alpha0)
        g = zeta - beta
        u = torch.stack([torch.mv(Q[k], g[k]) for k in range(K)])
    alpha = (torch.zeros(K, 2 * m, dtype=Q.dtype, device=Q.device)
             if alpha0 is None else alpha0.clone())
    return alpha, u


def solve(Q: Tensor, params: ODMParams, mscale: float,
          alpha0: Tensor | None = None, tol: float = 1e-5,
          max_sweeps: int = 200, u0: Tensor | None = None) -> CDResult:
    """Run CD sweeps until the projected KKT residual drops below tol.

    ``alpha0`` is the warm start (Algorithm 1 line 12); zeros by default.
    ``u0`` is the optional precomputed cache Q (zeta0 - beta0). The KKT of
    the warm start is evaluated first, so an already-optimal start runs
    zero sweeps (Algorithm 1 line 5 reads this). Q (m, m) or a batch
    (K, m, m). CPU tensors run :func:`solve_plain`; CUDA tensors launch K4
    (:func:`launch_solve`, counted in ``solve.launches``).
    """
    given = [t for t in (Q, alpha0, u0) if t is not None]
    if on_cpu(*given):
        return solve_plain(Q, params, mscale, alpha0=alpha0, tol=tol,
                           max_sweeps=max_sweeps, u0=u0)
    single, Qb, a0, ub = _batched(Q, alpha0, u0)
    res = launch_solve(Qb, params, mscale, alpha0=a0, tol=tol,
                       max_sweeps=max_sweeps, u0=ub)
    solve.launches.bump()
    return _unbatch(single, res)


solve.launches = _counter("launch.cd_exact")


def transpose_padded(Q: Tensor) -> Tensor:
    """Q (K, m, m) transposed per partition into rows of a stride padded
    to a multiple of 4 floats (zeros beyond m), so that every row of the
    copy is 16-byte aligned: one copy, as a plain transpose would be."""
    K, m, _ = Q.shape
    ld = -(-m // 4) * 4
    qt = torch.empty(K, m, ld, dtype=Q.dtype, device=Q.device)
    qt[..., :m].copy_(Q.transpose(-1, -2))
    qt[..., m:].zero_()
    return qt


def state_in_smem(m: int) -> bool:
    """Whether K4 keeps alpha and u in shared memory at m (else in device
    memory). Needs the built library."""
    return bool(_build.library().cd_exact_state_in_smem(m))


def launch_solve(Q: Tensor, params: ODMParams, mscale: float,
                 alpha0: Tensor | None = None, tol: float = 1e-5,
                 max_sweeps: int = 200, u0: Tensor | None = None) -> CDResult:
    """K4 on CUDA tensors: Q (K, m, m), alpha0 (K, 2m), u0 (K, m). The
    start's cache is computed here as the plain version computes it, and
    Q is handed over transposed (:func:`transpose_padded`) so the kernel
    reads the reference's column Q[:, row] as one aligned row."""
    K, m, _ = Q.shape
    if Q.dtype != torch.float32 or Q.shape != (K, m, m) or m == 0:
        raise ValueError(f"Q: expected a float32 (K, m, m) tensor with "
                         f"m > 0, got {Q.dtype} {tuple(Q.shape)}")
    alpha, u = _start(Q, alpha0, u0)
    alpha, u = alpha.contiguous(), u.contiguous()
    if alpha.shape != (K, 2 * m) or u.shape != (K, m):
        raise ValueError(f"alpha0/u0: expected ({K}, {2 * m}) and "
                         f"({K}, {m}), got {tuple(alpha.shape)} and "
                         f"{tuple(u.shape)}")
    qt = transpose_padded(Q)
    qd = torch.diagonal(Q, dim1=-2, dim2=-1).contiguous()
    # u's two buffers, used where they do not fit in shared memory
    scratch = torch.empty(K, 2, qt.shape[-1], dtype=torch.float32,
                          device=Q.device)
    sweeps = torch.empty(K, dtype=torch.int32, device=Q.device)
    kkt = torch.empty(K, dtype=torch.float32, device=Q.device)
    # the constants as the plain version forms them: double products,
    # rounded to fp32 once (ctypes rounds to nearest)
    cz = mscale * params.c * params.ups
    cb = mscale * params.c
    with torch.cuda.device(Q.device):
        code = _build.library().cd_exact_f32(
            _build.ptr(qt), qt.shape[-1], _build.ptr(qd), _build.ptr(alpha),
            _build.ptr(u), _build.ptr(scratch), _build.ptr(sweeps),
            _build.ptr(kkt), K, m, max_sweeps, _f32(tol), cz, cb,
            params.theta - 1.0, params.theta + 1.0,
            _build.stream_handle(Q.device))
    _build.check(code, "cd_exact")
    return CDResult(alpha=alpha, u=u, sweeps=sweeps, kkt=kkt)


def solve_plain(Q: Tensor, params: ODMParams, mscale: float,
                alpha0: Tensor | None = None, tol: float = 1e-5,
                max_sweeps: int = 200, u0: Tensor | None = None,
                moves: Tensor | None = None) -> CDResult:
    """Plain version of K4: the reference's sweeps as a Python loop over
    the coordinates, batched over partitions; a converged partition stops
    moving while the others go on. ``moves``, an int64 tensor of K
    elements on Q's device, receives each partition's count of steps with
    delta != 0 (for the time per moving step K4 reports)."""
    single, Q, alpha0, u0 = _batched(Q, alpha0, u0)
    K, m, _ = Q.shape
    q_diag = torch.diagonal(Q, dim1=-2, dim2=-1)
    alpha, u = _start(Q, alpha0, u0)
    sweeps = torch.zeros(K, dtype=torch.int32, device=Q.device)
    kkt = kkt_from_u(u, alpha, params, mscale)
    tol32 = _f32(tol)
    while True:
        active = (sweeps < max_sweeps) & (kkt > tol32)
        if not bool(active.any()):
            break
        _sweep(Q, q_diag, alpha, u, active, params, mscale,
               None if moves is None else moves.view(-1))
        sweeps += active.to(torch.int32)
        kkt = torch.where(active, kkt_from_u(u, alpha, params, mscale), kkt)
    return _unbatch(single, CDResult(alpha=alpha, u=u, sweeps=sweeps,
                                     kkt=kkt))


# ---------------------------------------------------------------------------
# block-Gauss-Seidel variant (oracle for the tile kernels)
# ---------------------------------------------------------------------------

def _tile_solve(qblk: Tensor, dblk: Tensor, ablk: Tensor, ublk: Tensor,
                vblk: Tensor, params: ODMParams, mscale: float) -> Tensor:
    """Exact Gauss-Seidel inside every tile at once: qblk (T, B, B),
    ablk (T, 2B), ublk (T, B), vblk (T, B) bool. Returns the new ablk."""
    block = qblk.shape[-1]
    a, u = ablk.clone(), ublk.clone()
    cz = mscale * params.c * params.ups
    cb = mscale * params.c
    for i in range(2 * block):
        is_zeta = i < block
        row = i if is_zeta else i - block
        a_i = a[:, i]
        if is_zeta:
            g = u[:, row] + cz * a_i + (params.theta - 1.0)
            h = dblk[:, row] + cz
        else:
            g = -u[:, row] + cb * a_i + (params.theta + 1.0)
            h = dblk[:, row] + cb
        new = torch.clamp_min(a_i - g / h, 0.0)
        new = torch.where(vblk[:, row], new, torch.zeros_like(new))
        delta = new - a_i
        sign = 1.0 if is_zeta else -1.0
        u = u + (sign * delta)[:, None] * qblk[:, :, row]
        a[:, i] = new
    return a


def _kkt_padded(u: Tensor, alpha: Tensor, valid: Tensor, params: ODMParams,
                mscale: float) -> Tensor:
    g = dual_grad_from_u(u, alpha, params, mscale)
    v2 = torch.cat([valid, valid], dim=-1)
    proj = projected_violation(g, alpha)
    return torch.amax(torch.where(v2, proj, torch.zeros_like(proj)), dim=-1)


def solve_block(Q: Tensor, params: ODMParams, mscale: float,
                block: int = 256, alpha0: Tensor | None = None,
                tol: float = 1e-5, max_outer: int = 200,
                u0: Tensor | None = None) -> CDResult:
    """Exact CD within each ``block``-sized tile, Jacobi across tiles.

    Cross-tile coupling enters through the cache u, refreshed once per
    outer pass; each pass is safeguarded by the exact line search along
    the joint Jacobi step (f is quadratic along it and u moves linearly),
    which keeps simultaneous tile solves monotone for any Q.
    """
    single, Q, alpha0, u0 = _batched(Q, alpha0, u0)
    K, m, _ = Q.shape
    nblk = -(-m // block)
    mp = nblk * block
    pad = mp - m
    Qp = torch.nn.functional.pad(Q, (0, pad, 0, pad))
    q_diag = torch.diagonal(Qp, dim1=-2, dim2=-1)
    valid = (torch.arange(mp, device=Q.device) < m)[None].expand(K, mp)

    alpha = torch.zeros(K, 2 * mp, dtype=Q.dtype, device=Q.device)
    if alpha0 is not None:
        z0, b0 = split_alpha(alpha0)
        alpha[:, :m] = z0
        alpha[:, mp:mp + m] = b0

    c, ups, theta = params.c, params.ups, params.theta
    tiles = K * nblk
    idx = torch.arange(nblk, device=Q.device) * block
    rows = idx[:, None] + torch.arange(block, device=Q.device)
    # diagonal tiles (K, nblk, B, B) are fixed for the whole solve
    qblk = Qp[:, rows[:, :, None], rows[:, None, :]].reshape(
        tiles, block, block)
    dblk = q_diag.reshape(tiles, block)
    vblk = valid.reshape(tiles, block)

    if u0 is None:
        u = torch.einsum("kij,kj->ki", Qp, alpha[:, :mp] - alpha[:, mp:])
    else:
        u = torch.nn.functional.pad(u0, (0, pad))
    it = torch.zeros(K, dtype=torch.int32, device=Q.device)
    kkt = _kkt_padded(u, alpha, valid, params, mscale)
    tol32 = _f32(tol)
    while True:
        active = (it < max_outer) & (kkt > tol32)
        if not bool(active.any()):
            break
        zeta, beta = alpha[:, :mp], alpha[:, mp:]
        ablk = torch.cat([zeta.reshape(tiles, block),
                          beta.reshape(tiles, block)], dim=1)
        ablk = _tile_solve(qblk, dblk, ablk, u.reshape(tiles, block), vblk,
                           params, mscale)
        z_new = ablk[:, :block].reshape(K, mp)
        b_new = ablk[:, block:].reshape(K, mp)
        dz, db = z_new - zeta, b_new - beta
        u_d = torch.einsum("kij,kj->ki", Qp, dz - db)
        gz = u + mscale * c * ups * zeta + (theta - 1.0)
        gb = -u + mscale * c * beta + (theta + 1.0)
        gdot = torch.sum(gz * dz, -1) + torch.sum(gb * db, -1)
        quad = torch.sum((dz - db) * u_d, -1) + mscale * c * (
            ups * torch.sum(dz * dz, -1) + torch.sum(db * db, -1))
        t = torch.where(quad > 0.0,
                        torch.clamp(-gdot / torch.clamp_min(quad, 1e-30),
                                    0.0, 1.0),
                        torch.ones_like(quad))
        t = torch.where(active, t, torch.zeros_like(t))[:, None]
        alpha = torch.cat([zeta + t * dz, beta + t * db], dim=1)
        u = u + t * u_d
        it += active.to(torch.int32)
        kkt = torch.where(active,
                          _kkt_padded(u, alpha, valid, params, mscale), kkt)
    zeta, beta = alpha[:, :mp], alpha[:, mp:]
    out = torch.cat([zeta[:, :m], beta[:, :m]], dim=1)
    u = torch.einsum("kij,kj->ki", Q, zeta[:, :m] - beta[:, :m])
    return _unbatch(single, CDResult(alpha=out, u=u, sweeps=it, kkt=kkt))


def objective(Q: Tensor, alpha: Tensor, params: ODMParams,
              mscale: float) -> Tensor:
    return dual_objective(Q, alpha, params, mscale)
