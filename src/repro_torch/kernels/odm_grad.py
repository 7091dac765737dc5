"""Fused linear-kernel primal ODM gradients: the DSVRG route's kernels.

Port of ``repro.kernels.odm_grad``. Two fused passes share one layout:

* :func:`odm_grad` — the full-batch anchor gradient

      grad p(w) = w + s · Xᵀ[(lo + ups·hi) ⊙ y],  s = lam / (M (1-θ)²)

  B7 (``csrc/odm_grad.cu``): a grid over blocks of 64 to 256 rows writes
  a (n_blocks, d) partial buffer, a second launch sums it per column in
  block order and adds ``w``. X is read from device memory once.
* :func:`odm_svrg_grad` — the DSVRG inner-step direction

      g_w − g_a + h = (w − a + h) + Xᵀ[(coef_w − coef_a) ⊙ wt] · inv_n

  B6 (same source): one CTA per chain, both margins from one pass over
  each row. An optional leading chain axis (x (C, B, d), y (C, B),
  w (C, d); ``anchor``, ``h``, ``wt`` and ``inv_n`` shared) advances every
  chain of the parallel schedule in one launch. ``inv_n`` is a one-element
  device tensor the kernel reads itself, so no caller reads a device value.

A CPU tensor takes the plain version (:func:`odm_grad_plain`,
:func:`odm_svrg_grad_plain`), a CUDA tensor the kernel; each wrapper
counts its calls that launch (``odm_grad.launches``,
``odm_svrg_grad.launches``; one per call, though B7 is two launches). The
kernels mask the ragged edge themselves, so nothing is padded to a tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._device import on_cpu
from repro_torch.kernels.gram import _check_f32

Tensor = torch.Tensor


def _hinge_coef(m: Tensor, y: Tensor, *, s: float, theta: float,
                ups: float) -> Tensor:
    """Per-instance coefficient s·(lo + ups·hi)·y (odm._hinge_coef)."""
    lo = torch.where(m < 1.0 - theta, m + theta - 1.0, 0.0)
    hi = torch.where(m > 1.0 + theta, m - theta - 1.0, 0.0)
    return s * (lo + ups * hi) * y


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def odm_grad_plain(w: Tensor, x: Tensor, y: Tensor, *, lam: float = 1.0,
                   theta: float = 0.1, ups: float = 0.5) -> Tensor:
    """Plain version of B7: w + Xᵀ coef with s = lam / (M (1-θ)²)."""
    s = lam / (x.shape[0] * (1.0 - theta) ** 2)
    coef = _hinge_coef(y * (x @ w), y, s=s, theta=theta, ups=ups)
    return w + coef @ x


def odm_svrg_grad_plain(w: Tensor, anchor: Tensor, h: Tensor, x: Tensor,
                        y: Tensor, wt: Tensor, inv_n: Tensor, *, s: float,
                        theta: float = 0.1, ups: float = 0.5) -> Tensor:
    """Plain version of B6, in the TPU kernel's order: the coefficient
    difference is masked by ``wt`` and scaled by ``inv_n`` before the
    back-projection. Batched over a leading chain axis of x, y and w."""
    kw = dict(s=s, theta=theta, ups=ups)
    dcoef = _hinge_coef(y * (x @ w[..., :, None])[..., 0], y, **kw) \
        - _hinge_coef(y * (x @ anchor), y, **kw)
    dcoef = dcoef * wt * inv_n.reshape(())
    return (w - anchor + h) + (dcoef[..., None, :] @ x)[..., 0, :]


# ---------------------------------------------------------------------------
# launchers (CUDA tensors)
# ---------------------------------------------------------------------------

def _check_chains(name: str, t: Tensor, shape: tuple[int, ...]) -> None:
    """``_check_f32`` for a tensor whose leading chain axis may be strided
    (a (C, B, d) slice of the solver's (K, S, b, d) layout)."""
    if t.ndim != len(shape) or t.shape[0] != shape[0] or shape[0] == 0:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    _check_f32(name, t[0], shape[1:])


def launch_odm_svrg_grad(w: Tensor, anchor: Tensor, h: Tensor, x: Tensor,
                         y: Tensor, wt: Tensor, inv_n: Tensor, *, s: float,
                         theta: float, ups: float) -> Tensor:
    """B6 on CUDA tensors. x (B, d) or (C, B, d) (the chain axis may be
    strided), y (B,) or (C, B), w (d,) or (C, d); anchor, h (d,), wt (B,),
    inv_n one element."""
    batched = x.ndim == 3
    C = x.shape[0] if batched else 1
    B, d = x.shape[-2:]
    rows = _check_chains if batched else _check_f32
    rows("x", x, (C, B, d) if batched else (B, d))
    rows("y", y, (C, B) if batched else (B,))
    _check_f32("w", w, (C, d) if batched else (d,))
    for name, t, shape in (("anchor", anchor, (d,)), ("h", h, (d,)),
                           ("wt", wt, (B,))):
        _check_f32(name, t, shape)
    if inv_n.numel() != 1 or inv_n.dtype != torch.float32:
        raise ValueError("inv_n: expected one float32 element")
    out = torch.empty_like(w)
    # the hinge edges 1 ∓ θ reach the kernel as fp32 (ctypes rounds), the
    # values the plain version compares the fp32 margins with
    with torch.cuda.device(x.device):
        code = _build.library().odm_svrg_grad_f32(
            _build.ptr(w), _build.ptr(anchor), _build.ptr(h), _build.ptr(x),
            x.stride(0) if batched else 0, _build.ptr(y),
            y.stride(0) if batched else 0, _build.ptr(wt),
            _build.ptr(inv_n), _build.ptr(out), C, B, d, s, theta, ups,
            1.0 - theta, 1.0 + theta, _build.stream_handle(x.device))
    _build.check(code, "odm_svrg_grad")
    return out


def launch_odm_grad(w: Tensor, x: Tensor, y: Tensor, *, lam: float,
                    theta: float, ups: float) -> Tensor:
    """B7 on CUDA tensors: w (d,), x (M, d), y (M,) -> (d,)."""
    M, d = x.shape
    _check_f32("w", w, (d,))
    _check_f32("x", x, (M, d))
    _check_f32("y", y, (M,))
    lib = _build.library()
    part = torch.empty(lib.odm_grad_blocks(M), d, dtype=torch.float32,
                       device=x.device)
    out = torch.empty_like(w)
    s = lam / (M * (1.0 - theta) ** 2)
    with torch.cuda.device(x.device):
        code = lib.odm_grad_f32(
            _build.ptr(w), _build.ptr(x), _build.ptr(y), _build.ptr(part),
            _build.ptr(out), M, d, s, theta, ups, 1.0 - theta, 1.0 + theta,
            _build.stream_handle(x.device))
    _build.check(code, "odm_grad")
    return out


# ---------------------------------------------------------------------------
# dispatching wrappers
# ---------------------------------------------------------------------------

def odm_grad(w: Tensor, x: Tensor, y: Tensor, *, lam: float = 1.0,
             theta: float = 0.1, ups: float = 0.5) -> Tensor:
    """Full-batch grad p(w), s = lam / (M (1-θ)²) with M = x.shape[0]. CPU
    tensors run the plain version; CUDA tensors launch B7 (counted in
    ``odm_grad.launches``)."""
    if on_cpu(w, x, y):
        return odm_grad_plain(w, x, y, lam=lam, theta=theta, ups=ups)
    out = launch_odm_grad(w, x, y, lam=lam, theta=theta, ups=ups)
    odm_grad.launches += 1
    return out


odm_grad.launches = 0


def odm_svrg_grad(w: Tensor, anchor: Tensor, h: Tensor, x: Tensor,
                  y: Tensor, wt: Tensor, inv_n: Tensor, *, s: float,
                  theta: float = 0.1, ups: float = 0.5) -> Tensor:
    """Fused g_w − g_a + h on one masked minibatch (or C of them).

    ``wt`` (B,) is 1.0 on real rows and 0.0 on padding; ``inv_n`` holds
    1/n_valid; ``s`` is the per-instance hinge scale lam/(1-θ)² (no 1/M).
    CPU tensors run the plain version; CUDA tensors launch B6 (counted in
    ``odm_svrg_grad.launches``)."""
    if on_cpu(w, anchor, h, x, y, wt, inv_n):
        return odm_svrg_grad_plain(w, anchor, h, x, y, wt, inv_n, s=s,
                                   theta=theta, ups=ups)
    out = launch_odm_svrg_grad(w, anchor, h, x, y, wt, inv_n, s=s,
                               theta=theta, ups=ups)
    odm_svrg_grad.launches += 1
    return out


odm_svrg_grad.launches = 0
