"""Block dual coordinate descent: greedy tile sweeps and the level solve.

Port of ``repro.kernels.dual_cd_block``. Inside each diagonal tile of a
partition's signed Gram, *Gauss-Southwell* (greedy) CD picks the worst
projected-gradient violator of the tile's 2B coordinates, applies the
exact clipped update and a rank-1 update of the cache u; a tile exits its
sweep once its in-tile KKT residual (measured at the start of a step, so
the exit lags one update) drops to ``exit_tol``. Tiles are Jacobi with
respect to each other: u is frozen at its pass-start value.

Kernels (each with a plain PyTorch version of the same signature; a CPU
tensor takes the plain version, a CUDA tensor the kernel):

* :func:`cd_block_sweep` — K1 (``csrc/cd_sweep.cu``), one warp per tile.
  K1 reads a tile's column as a row of the tile's transpose
  (:func:`transpose_tiles`); :func:`solve_level` makes that copy once a
  level, for CUDA tensors only.
* :func:`dense_matvec` — K3 (``csrc/dense_matvec.cu``), u_d = Q @ d over a
  materialized signed Q.

:func:`fused_cd_pass` is the reference's one-launch pass. On the TPU the
grid runs in order: at j = 0 each tile parks its step d_i in scratch and
every tile adds into one resident (1, mp) u_d row. On Hopper, CTAs run at
once and in no order, and u_d needs every d_i first, so the port's pass
is one Python function that launches K1 and then K3 (dense) or K2
(matrix-free, ``csrc/gram_matvec.cu``) in that fixed order and returns
the reference's ``(alphas', u_d)``. A persistent single-launch design is
later work.

:func:`solve_level` drives the pass loop: exact line search along the
joint Jacobi step, exact KKT stop (one host sync per pass), warm starts
and masked padding.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.invariants import counter as _counter
from repro_torch.kernels import _build
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels._device import on_cpu

Tensor = torch.Tensor


def flush_subnormals(a: Tensor) -> Tensor:
    """Zero the fp32 subnormals of ``a``, as the reference's devices do (the
    TPU, and XLA on the CPU, flush subnormals to zero; PyTorch keeps them).

    It matters for the line search: a coordinate the sweep clips to 0
    shrinks by (1 − t) a pass. Flushed, it reaches 0 and its KKT term
    becomes max(−g, 0); kept, it can stop at the least subnormal for good
    (t < 1/2 rounds the product back up), and |g| then holds the level's
    KKT above tol until ``n_passes`` runs out."""
    return a.masked_fill(a.abs() < torch.finfo(a.dtype).tiny, 0.0)


def _coefs(c: float, ups: float, theta: float, mscale: float):
    """The step's scalars as the reference forms them: Python doubles,
    cast to fp32 where they meet a tensor."""
    return mscale * c * ups, mscale * c, theta - 1.0, theta + 1.0


def _greedy_tile_sweep(qblk: Tensor, alpha: Tensor, u: Tensor,
                       valid2: Tensor, *, c: float, ups: float,
                       theta: float, mscale: float, n_steps: int,
                       exit_tol: float) -> tuple[Tensor, Tensor]:
    """Greedy CD on T diagonal tiles at once, with per-tile early exit.

    qblk (T, B, B), alpha (T, 2B) [zeta; beta], u (T, B), valid2 (T, 2B).
    Each tile runs until ``n_steps`` updates or until the max violation
    measured at the start of its previous step is <= ``exit_tol``; an
    exited tile stops moving while the others go on. ``exit_tol = 0.0``
    gives the fixed-step sweep. The plain version of K1.
    """
    T, B, _ = qblk.shape
    dev, dt = qblk.device, qblk.dtype
    cz, cb, tm1, tp1 = _coefs(c, ups, theta, mscale)
    q_diag = torch.diagonal(qblk, dim1=-2, dim2=-1)
    h = torch.cat([q_diag + cz, q_diag + cb], dim=1).reshape(-1)
    # gradient of [zeta; beta] as one vector: g = (s + coef ⊙ alpha) + b
    # with s = [u; -u] kept up to date directly (negation is exact, so s
    # holds the same bits as recomputing -u)
    coef = torch.cat([torch.full((B,), cz, dtype=dt, device=dev),
                      torch.full((B,), cb, dtype=dt, device=dev)])
    lin = torch.cat([torch.full((B,), tm1, dtype=dt, device=dev),
                     torch.full((B,), tp1, dtype=dt, device=dev)])
    s = torch.cat([u, -u], dim=1)
    # column i of [[Q, -Q], [-Q, Q]] is the change of s per unit step of
    # coordinate i: ±Q[:, col] in the zeta half, its negation below
    q_aug = torch.cat([torch.cat([qblk, -qblk], dim=2),
                       torch.cat([-qblk, qblk], dim=2)], dim=1)
    alpha = alpha.clone()
    a_flat = alpha.view(-1)
    valid_flat = valid2.reshape(-1).to(dt)
    invalid = valid2 <= 0.0
    base = torch.arange(T, device=dev) * (2 * B)
    rows = torch.arange(T, device=dev)
    vmax = torch.full((T,), torch.finfo(dt).max, dtype=dt, device=dev)
    exit32 = torch.tensor(exit_tol, dtype=dt, device=dev)
    for _ in range(n_steps):
        active = vmax > exit32
        if not bool(active.any()):
            break
        g = s + coef * alpha
        g += lin
        viol = torch.where(alpha > 0.0, torch.abs(g),
                           torch.clamp_min(-g, 0.0))
        viol.masked_fill_(invalid, 0.0)
        fi = base + torch.argmax(viol, dim=1)
        a_i = a_flat[fi]
        new_i = torch.clamp_min(a_i - g.view(-1)[fi] / h[fi], 0.0)
        delta = (new_i - a_i) * valid_flat[fi]
        delta *= active
        a_flat[fi] = a_i + delta
        s += delta[:, None] * q_aug[rows, :, fi - base]
        vmax = torch.where(active, viol.view(-1)[fi], vmax)
    return alpha, s[:, :B].contiguous()


def transpose_tiles(q_blocks: Tensor) -> Tensor:
    """The tiles transposed, contiguous: row c of tile t is column c of
    ``q_blocks[t]``, the column K1 reads at a step. Counted in
    ``transpose_tiles.copies``."""
    transpose_tiles.copies += 1
    return q_blocks.transpose(-1, -2).contiguous()


transpose_tiles.copies = 0


def launch_cd_block_sweep(q_blocks: Tensor, alphas: Tensor, us: Tensor,
                          valids: Tensor, *, c: float, ups: float,
                          theta: float, mscale: float, n_steps: int,
                          exit_tol: float) -> tuple[Tensor, Tensor]:
    """K1 on CUDA tensors: q (T, B, B), alphas (T, 2B), us (T, B),
    valids (T, B). The kernel reads the tiles' transposes: a ``q_blocks``
    that is the transposed view of a contiguous tensor (as
    :func:`solve_level` passes it) is read in place, any other is copied
    by :func:`transpose_tiles` first."""
    T, B, _ = q_blocks.shape
    if q_blocks.dtype != torch.float32 or tuple(q_blocks.shape) != (T, B, B):
        raise ValueError(f"q_blocks: expected a float32 tensor of shape "
                         f"({T}, {B}, {B}), got {q_blocks.dtype} "
                         f"{tuple(q_blocks.shape)}")
    for name, t, shape in (("alphas", alphas, (T, 2 * B)),
                           ("us", us, (T, B)), ("valids", valids, (T, B))):
        gram_mod._check_f32(name, t, shape)
    if not 1 <= B <= 1024:
        raise ValueError(f"cd_block_sweep kernel takes 1 <= B <= 1024 "
                         f"(at most 32 rows a lane of one warp), got B={B}")
    a_out = torch.empty_like(alphas)
    u_out = torch.empty_like(us)
    if T == 0:
        return a_out, u_out
    q_t = q_blocks.transpose(-1, -2)
    if not q_t.is_contiguous():
        q_t = transpose_tiles(q_blocks)
    cz, cb, tm1, tp1 = _coefs(c, ups, theta, mscale)
    lib = _build.library()
    with torch.cuda.device(q_blocks.device):
        code = lib.cd_block_sweep_f32(
            _build.ptr(q_t), _build.ptr(alphas), _build.ptr(us),
            _build.ptr(valids), _build.ptr(a_out), _build.ptr(u_out), T, B,
            cz, cb, tm1, tp1, n_steps, exit_tol,
            _build.stream_handle(q_blocks.device))
    _build.check(code, "cd_block_sweep")
    return a_out, u_out


def cd_block_sweep(q_blocks: Tensor, alphas: Tensor, us: Tensor, *,
                   c: float, ups: float, theta: float, mscale: float,
                   n_steps: int, valids: Tensor | None = None,
                   exit_tol: float = 0.0) -> tuple[Tensor, Tensor]:
    """Run up to n_steps greedy-CD updates inside every diagonal tile.

    q_blocks (nblk, B, B), alphas (nblk, 2B), us (nblk, B) ->
    (alphas', us'). ``valids`` (nblk, B) marks real coordinates (1.0) vs
    padding (0.0), which stay frozen; defaults to all valid. CPU tensors
    run :func:`_greedy_tile_sweep`; CUDA tensors launch K1 (counted in
    ``cd_block_sweep.launches``).
    """
    nblk, B, _ = q_blocks.shape
    if valids is None:
        valids = torch.ones(nblk, B, dtype=q_blocks.dtype,
                            device=q_blocks.device)
    if on_cpu(q_blocks, alphas, us, valids):
        return _greedy_tile_sweep(q_blocks, alphas, us,
                                  torch.cat([valids, valids], dim=1), c=c,
                                  ups=ups, theta=theta, mscale=mscale,
                                  n_steps=n_steps, exit_tol=exit_tol)
    out = launch_cd_block_sweep(q_blocks, alphas, us, valids, c=c, ups=ups,
                                theta=theta, mscale=mscale, n_steps=n_steps,
                                exit_tol=exit_tol)
    cd_block_sweep.launches.bump()
    return out


cd_block_sweep.launches = _counter("launch.cd_block_sweep")


def extract_diag_blocks(Q: Tensor, block: int) -> Tensor:
    """(..., M, M) -> (..., M/block, block, block) diagonal blocks."""
    nblk = Q.shape[-1] // block
    idx = (torch.arange(nblk, device=Q.device)[:, None] * block
           + torch.arange(block, device=Q.device))
    return Q[..., idx[:, :, None], idx[:, None, :]]


# ---------------------------------------------------------------------------
# K3: dense signed-Q matvec
# ---------------------------------------------------------------------------

def dense_matvec_plain(q: Tensor, d: Tensor, bm: int = 256) -> Tensor:
    """Plain version of K3: u_d[k] = Q[k] @ d[k], streamed in ``bm``-row
    blocks."""
    K, M, _ = q.shape
    u = torch.empty(K, M, dtype=q.dtype, device=q.device)
    for r0 in range(0, M, bm):
        u[:, r0:r0 + bm] = (q[:, r0:r0 + bm] @ d[:, :, None])[:, :, 0]
    return u


def launch_dense_matvec(q: Tensor, d: Tensor) -> Tensor:
    """K3 on CUDA tensors: q (K, M, N), d (K, N) -> (K, M)."""
    K, M, N = q.shape
    gram_mod._check_f32("q", q, (K, M, N))
    gram_mod._check_f32("d", d, (K, N))
    u = torch.empty(K, M, dtype=torch.float32, device=q.device)
    if K == 0 or M == 0:
        return u
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.dense_matvec_f32(_build.ptr(q), _build.ptr(d),
                                    _build.ptr(u), K, M, N,
                                    _build.stream_handle(q.device))
    _build.check(code, "dense_matvec")
    return u


def dense_matvec(q: Tensor, d: Tensor, bm: int = 256) -> Tensor:
    """u_d[k] = Q[k] @ d[k] for the dense fused pass. CPU tensors run the
    plain version; CUDA tensors launch K3 (``dense_matvec.launches``)."""
    if on_cpu(q, d):
        return dense_matvec_plain(q, d, bm=bm)
    u = launch_dense_matvec(q, d)
    dense_matvec.launches.bump()
    return u


dense_matvec.launches = _counter("launch.dense_matvec")


# ---------------------------------------------------------------------------
# the fused pass: tile sweeps, then the cross-tile Gram matvec
# ---------------------------------------------------------------------------

def fused_cd_pass(q_blocks: Tensor, src, alphas: Tensor, us: Tensor,
                  valids: Tensor, *, c: float, ups: float, theta: float,
                  mscale: float, n_steps: int,
                  exit_tol: float) -> tuple[Tensor, Tensor]:
    """One Jacobi pass for a whole level: every diagonal tile's sweep (K1),
    then u_d = Q (dz - db) — K3 over a :class:`~repro_torch.kernels.gram
    .DenseSource`, K2 through a :class:`~repro_torch.kernels.gram
    .KernelSource`.

    q_blocks (K, nblk, B, B), alphas (K, nblk, 2B), us (K, nblk, B),
    valids (K, nblk, B) -> (alphas' (K, nblk, 2B), u_d (K, m)).
    """
    K, nblk, B, _ = q_blocks.shape
    a_new, _ = cd_block_sweep(
        q_blocks.reshape(K * nblk, B, B), alphas.reshape(K * nblk, 2 * B),
        us.reshape(K * nblk, B), c=c, ups=ups, theta=theta, mscale=mscale,
        n_steps=n_steps, valids=valids.reshape(K * nblk, B),
        exit_tol=exit_tol)
    a_new = a_new.reshape(K, nblk, 2 * B)
    d = ((a_new[:, :, :B] - alphas[:, :, :B])
         - (a_new[:, :, B:] - alphas[:, :, B:])).reshape(K, nblk * B)
    if isinstance(src, gram_mod.DenseSource):
        u_d = dense_matvec(src.q, d.contiguous())
    else:
        u_d = src.matvec(d)
    return a_new, u_d


# ---------------------------------------------------------------------------
# level solve: pass loop + exact line search + exact KKT stop
# ---------------------------------------------------------------------------

def solve_level(q_blocks: Tensor, src, alphas0: Tensor, *, c: float,
                ups: float, theta: float, mscale: float,
                steps_per_pass: int | None = None, n_passes: int = 30,
                tol: float = 1e-5, valid: Tensor | None = None,
                us0: Tensor | None = None, adaptive: bool = True
                ) -> tuple[Tensor, Tensor, int]:
    """Block-CD solve of K same-size partitions, all advanced together.

    Args:
      q_blocks: (K, nblk, B, B) diagonal Gram blocks of each partition.
      src:      gram source for the off-diagonal mass (DenseSource or
                KernelSource).
      alphas0:  (K, 2m) warm starts; zeros give a cold start.
      valid:    (m,) mask of real vs padded coordinates. Padded
                coordinates stay frozen at zero and are left out of the
                KKT residual.
      us0:      optional (K, m) precomputed matvec(zeta0 - beta0).
      adaptive: tiles early-exit at in-tile KKT <= 0.01·tol; convergence
                is still decided by the exact full-problem KKT.

    Every pass is one :func:`fused_cd_pass`. The reference's two-launch
    layout (sweep kernel, then ``src.matvec``) is the same math and, on
    Hopper, the same two launches, so the port has no switch for it.

    The pass loop stops when the worst partition's projected-KKT residual
    is <= tol or after ``n_passes`` passes; the KKT of the warm start is
    checked first, so an already-optimal start returns 0 passes.

    Returns (alphas (K, 2m), kkts (K,), passes).
    """
    K, nblk, B, _ = q_blocks.shape
    m = nblk * B
    n_steps = 2 * B if steps_per_pass is None else steps_per_pass
    exit_tol = 0.01 * tol if adaptive else 0.0
    dev, dt = q_blocks.device, q_blocks.dtype
    if valid is None:
        valid = torch.ones(m, dtype=dt, device=dev)
    valid = valid.to(dt)
    valids = valid.reshape(1, nblk, B).expand(K, nblk, B).contiguous()
    valid2 = torch.cat([valid, valid])[None, :] > 0.0
    cz, cb, tm1, tp1 = _coefs(c, ups, theta, mscale)
    if q_blocks.is_cuda:
        # K1 reads the tiles transposed; q_blocks is fixed for the whole
        # pass loop, so transpose once here and hand every pass a view
        # with q_blocks' values over the transposed storage
        q_blocks = transpose_tiles(q_blocks).transpose(-1, -2)

    def kkt(alphas, us):
        gz = us + cz * alphas[:, :m] + tm1
        gb = -us + cb * alphas[:, m:] + tp1
        g = torch.cat([gz, gb], dim=1)
        viol = torch.where(alphas > 0.0, torch.abs(g),
                           torch.clamp_min(-g, 0.0))
        return torch.amax(torch.where(valid2, viol, torch.zeros_like(viol)),
                          dim=1)

    alphas = flush_subnormals(alphas0)
    if us0 is None:
        us0 = src.matvec(alphas[:, :m] - alphas[:, m:])
    us = us0
    r = kkt(alphas, us)
    tol32 = float(np.float32(tol))
    it = 0
    while it < n_passes and float(torch.max(r)) > tol32:
        zetas, betas = alphas[:, :m], alphas[:, m:]
        a_t = torch.cat([zetas.reshape(K, nblk, B),
                         betas.reshape(K, nblk, B)], dim=2)
        a_t, u_d = fused_cd_pass(q_blocks, src, a_t, us.reshape(K, nblk, B),
                                 valids, c=c, ups=ups, theta=theta,
                                 mscale=mscale, n_steps=n_steps,
                                 exit_tol=exit_tol)
        dz = a_t[:, :, :B].reshape(K, m) - zetas
        db = a_t[:, :, B:].reshape(K, m) - betas
        # exact line search along each partition's joint Jacobi step
        gz = us + cz * zetas + tm1
        gb = -us + cb * betas + tp1
        gdot = torch.sum(gz * dz + gb * db, dim=1)
        quad = torch.sum((dz - db) * u_d, dim=1) + cb * torch.sum(
            ups * dz * dz + db * db, dim=1)
        t = torch.where(quad > 0.0,
                        torch.clamp(-gdot / torch.clamp_min(quad, 1e-30),
                                    0.0, 1.0),
                        torch.ones_like(quad))[:, None]
        alphas = flush_subnormals(torch.cat([zetas + t * dz, betas + t * db],
                                            dim=1))
        us = us + t * u_d
        r = kkt(alphas, us)
        it += 1
    return alphas, r, it


def solve(Q: Tensor, *, c: float, ups: float, theta: float, mscale: float,
          block: int = 256, steps_per_pass: int | None = None,
          n_passes: int = 30, tol: float = 1e-5,
          alpha0: Tensor | None = None, valid: Tensor | None = None,
          adaptive: bool = True) -> tuple[Tensor, Tensor, int]:
    """Full block-CD solve of one (M, M) Q (M a multiple of ``block``).
    Returns (alpha, kkt, passes)."""
    M = Q.shape[0]
    if M % block:
        raise ValueError(f"M={M} must be a multiple of block={block}")
    qb = extract_diag_blocks(Q, block)[None]
    a0 = torch.zeros(2 * M, dtype=Q.dtype, device=Q.device) \
        if alpha0 is None else alpha0
    alphas, r, it = solve_level(
        qb, gram_mod.DenseSource(Q[None].contiguous()), a0[None], c=c,
        ups=ups, theta=theta, mscale=mscale, steps_per_pass=steps_per_pass,
        n_passes=n_passes, tol=tol, valid=valid, adaptive=adaptive)
    return alphas[0], r[0], it
