"""Public entry points for the kernels: shape handling around them.

Port of ``repro.kernels.ops`` (the main-path subset: ``gram_matvec``,
``rbf_gram_matvec``, ``dual_cd_solve``, ``decision_scores``). The CUDA
kernels mask ragged edges themselves, so only the block solve, whose
greedy trajectory depends on the tile, pads (to the block, with the
padded coordinates masked). Dispatch goes by the tensors' device
(:mod:`repro_torch.kernels._device`), not by what the host has.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dual_cd_block as _cd
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import score as _score

Tensor = torch.Tensor


class _RbfSpec:
    """Minimal KernelSpec stand-in so kernels/ never imports core."""

    name = "rbf"
    degree = 3
    coef0 = 1.0

    def __init__(self, gamma: float):
        self.gamma = gamma


def dual_cd_solve(Q: Tensor, *, c: float, ups: float, theta: float,
                  mscale: float, block: int = 256, n_passes: int = 50,
                  tol: float = 1e-5, steps_per_pass: int | None = None,
                  alpha0: Tensor | None = None,
                  adaptive: bool = True) -> tuple[Tensor, Tensor, int]:
    """Solve the ODM dual with the greedy block pass. Pads M to the block;
    padded coordinates are frozen at zero and left out of the KKT."""
    M = Q.shape[0]
    block = min(block, M)
    Mp = -(-M // block) * block
    Qp = torch.nn.functional.pad(Q, (0, Mp - M, 0, Mp - M))
    a0 = None
    if alpha0 is not None:
        a0 = torch.zeros(2 * Mp, dtype=Q.dtype, device=Q.device)
        a0[:M] = alpha0[:M]
        a0[Mp:Mp + M] = alpha0[M:]
    valid = ((torch.arange(Mp, device=Q.device) < M).to(Q.dtype)
             if Mp != M else None)
    alpha, kkt, passes = _cd.solve(
        Qp, c=c, ups=ups, theta=theta, mscale=mscale, block=block,
        n_passes=n_passes, tol=tol, steps_per_pass=steps_per_pass,
        alpha0=a0, valid=valid, adaptive=adaptive)
    return torch.cat([alpha[:M], alpha[Mp:Mp + M]]), kkt, passes


def gram_matvec(x: Tensor, g: Tensor, spec, *, y: Tensor | None = None,
                bm: int = 256) -> Tensor:
    """u[k] = Q_k @ g[k] for any ``KernelSpec`` family, never materialized.

    x (K, m, d), g (K, m); y (K, m) labels make it the signed product
    u = y ⊙ (K @ (y ⊙ g)).
    """
    gs = g if y is None else y * g
    u = _gram.gram_matvec(x.contiguous(), x.contiguous(), gs.contiguous(),
                          kind=spec.name, gamma=spec.gamma,
                          degree=spec.degree, coef0=spec.coef0, bm=bm)
    return u if y is None else y * u


def rbf_gram_matvec(x: Tensor, g: Tensor, *, gamma: float,
                    y: Tensor | None = None, bm: int = 256) -> Tensor:
    """RBF-pinned convenience over :func:`gram_matvec`."""
    return gram_matvec(x, g, _RbfSpec(gamma), y=y, bm=bm)


def decision_scores(x: Tensor, z: Tensor, coef: Tensor, spec, *,
                    bt: int = 256, tiled: bool | None = None) -> Tensor:
    """f (T,) = K(x, z) @ coef — the serving hot path.

    ``z`` (S, d) is the packed support-vector slab, ``coef`` (S,) its
    dual coefficients y ⊙ (ζ − β). ``tiled=None`` or ``True`` goes
    through :func:`repro_torch.kernels.score.score_tiles` (the kernel on
    CUDA tensors, its row-block streaming plain version on CPU tensors);
    ``tiled=False`` is the dense oracle.
    """
    kw = dict(kind=spec.name, gamma=spec.gamma, degree=spec.degree,
              coef0=spec.coef0)
    if tiled is False:
        return _score.score_ref(x, z, coef, **kw)
    return _score.score_tiles(x.contiguous(), z.contiguous(),
                              coef.contiguous(), bt=bt, **kw)
