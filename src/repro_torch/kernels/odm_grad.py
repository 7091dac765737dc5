"""Fused linear-kernel primal ODM gradients: the DSVRG route's kernels.

Port of ``repro.kernels.odm_grad``. Two fused passes share one layout:

* :func:`odm_grad` — the full-batch anchor gradient

      grad p(w) = w + s · Xᵀ[(lo + ups·hi) ⊙ y],  s = lam / (M (1-θ)²)

  B7 (``csrc/odm_grad.cu``): about two CTAs an SM, each over a fixed
  range of rows that streams through a shared-memory ring, write a
  (n_blocks, d) partial buffer; a second launch sums it per column in
  block order and adds ``w``. X is read from device memory once.
* :func:`odm_svrg_grad` — the DSVRG inner-step direction

      g_w − g_a + h = (w − a + h) + Xᵀ[(coef_w − coef_a) ⊙ wt] · inv_n

  B6 (same source): one CTA per chain, both margins from one pass over
  each row. An optional leading chain axis (x (C, B, d), y (C, B),
  w (C, d); ``anchor``, ``h``, ``wt`` and ``inv_n`` shared) advances every
  chain of the parallel schedule in one launch. ``inv_n`` is a one-element
  device tensor the kernel reads itself, so no caller reads a device value.
* :func:`odm_svrg_epoch` — a whole DSVRG / SVRG epoch of inner steps
  ``w ← w − eta · (g_w − g_a + h)``, the counterpart of the reference's
  ``lax.scan`` over :func:`odm_svrg_grad` (``repro.core.dsvrg``
  ``_epoch_serial`` / ``_epoch_parallel``). On the card one launch of
  the epoch kernel (same source): one CTA per chain walks every step of
  its chain in order with B6's arithmetic, w in shared memory and the
  next minibatch loading through a cp.async ring while the current one
  is computed, so w equals the per-step path's bit for bit and the host
  enqueues one launch an epoch instead of three ops a step.

A CPU tensor takes the plain version (:func:`odm_grad_plain`,
:func:`odm_svrg_grad_plain`, :func:`odm_svrg_epoch_plain`), a CUDA tensor
the kernel; each wrapper counts its calls that launch
(``odm_grad.launches``, ``odm_svrg_grad.launches``,
``odm_svrg_epoch.launches``; one per call, though B7 is two launches).
The kernels mask the ragged edge themselves, so nothing is padded to a
tile.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.invariants import counter as _counter
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


SCHEDULES = ("serial", "parallel")


def odm_svrg_epoch_plain(w: Tensor, anchor: Tensor, h: Tensor, xs: Tensor,
                         ys: Tensor, wts: Tensor, inv_n: Tensor, eta: Tensor,
                         *, s: float, theta: float = 0.1, ups: float = 0.5,
                         schedule: str = "serial") -> Tensor:
    """Plain version of the epoch kernel: the loop of
    :func:`odm_svrg_grad_plain` steps, each followed by ``w − eta · dir``.
    ``serial`` walks the K chains' S steps in one round-robin chain from
    w (d,) and returns (d,); ``parallel`` advances K chains from w in
    lockstep and returns their last iterates (K, d)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    K, S = ys.shape[:2]
    kw = dict(s=s, theta=theta, ups=ups)
    if schedule == "serial":
        for k in range(K):
            xk, yk = xs[k], ys[k]
            for t in range(S):
                w = w - eta * odm_svrg_grad_plain(w, anchor, h, xk[t], yk[t],
                                                  wts[t], inv_n[t], **kw)
        return w
    ws = w.expand(K, -1).contiguous()
    for t in range(S):
        ws = ws - eta * odm_svrg_grad_plain(ws, anchor, h, xs[:, t],
                                            ys[:, t], wts[t], inv_n[t], **kw)
    return ws


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


def _check_steps(name: str, t: Tensor, shape: tuple[int, ...]) -> None:
    """A per-step table (S, ...) whose step axis may have stride 0 (one
    row shared by every step) and whose rows are contiguous."""
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t[0].is_contiguous()):
        raise ValueError(f"{name}: expected a float32 tensor of shape "
                         f"{shape} with contiguous rows, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")


def launch_odm_svrg_epoch(w: Tensor, anchor: Tensor, h: Tensor, xs: Tensor,
                          ys: Tensor, wts: Tensor, inv_n: Tensor,
                          eta: Tensor, *, s: float, theta: float, ups: float,
                          schedule: str) -> Tensor:
    """The epoch kernel on CUDA tensors: xs (K, S, b, d), ys (K, S, b)
    contiguous; wts (S, b) and inv_n (S, 1) or (S,), whose step axis may
    have stride 0; w, anchor, h (d,); eta one element. Returns (d,) for
    ``serial``, the K chains' (K, d) for ``parallel``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    K, S, b, d = xs.shape
    _check_f32("xs", xs, (K, S, b, d))
    _check_f32("ys", ys, (K, S, b))
    for name, t in (("w", w), ("anchor", anchor), ("h", h)):
        _check_f32(name, t, (d,))
    _check_steps("wts", wts, (S, b))
    _check_steps("inv_n", inv_n, (S,) + tuple(inv_n.shape[1:]))
    if inv_n[0].numel() != 1 or eta.numel() != 1 \
            or eta.dtype != torch.float32:
        raise ValueError("inv_n: expected one float32 element a step, eta "
                         "one float32 element")
    serial = schedule == "serial"
    C, steps = (1, K * S) if serial else (K, S)
    out = w.clone() if serial else w.expand(K, d).contiguous()
    scratch = torch.empty_like(out)
    with torch.cuda.device(xs.device):
        code = _build.library().odm_svrg_epoch_f32(
            _build.ptr(out), _build.ptr(scratch), _build.ptr(anchor),
            _build.ptr(h), _build.ptr(xs), S * b * d, _build.ptr(ys), S * b,
            _build.ptr(wts), wts.stride(0), _build.ptr(inv_n),
            inv_n.stride(0), _build.ptr(eta), C, steps, S, b, d, s, theta,
            ups, 1.0 - theta, 1.0 + theta, _build.stream_handle(xs.device))
    _build.check(code, "odm_svrg_epoch")
    return out


def launch_odm_grad(w: Tensor, x: Tensor, y: Tensor, *, lam: float,
                    theta: float, ups: float) -> Tensor:
    """B7 on CUDA tensors: w (d,), x (M, d), y (M,) -> (d,)."""
    M, d = x.shape
    _check_f32("w", w, (d,))
    _check_f32("x", x, (M, d))
    _check_f32("y", y, (M,))
    lib = _build.library()
    part = torch.empty(lib.odm_grad_blocks(M, d), d, dtype=torch.float32,
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
    if on_cpu(w, x, y, kernel="odm_grad"):
        return odm_grad_plain(w, x, y, lam=lam, theta=theta, ups=ups)
    out = launch_odm_grad(w, x, y, lam=lam, theta=theta, ups=ups)
    odm_grad.launches.bump()
    return out


odm_grad.launches = _counter("launch.odm_grad")


def odm_svrg_grad(w: Tensor, anchor: Tensor, h: Tensor, x: Tensor,
                  y: Tensor, wt: Tensor, inv_n: Tensor, *, s: float,
                  theta: float = 0.1, ups: float = 0.5) -> Tensor:
    """Fused g_w − g_a + h on one masked minibatch (or C of them).

    ``wt`` (B,) is 1.0 on real rows and 0.0 on padding; ``inv_n`` holds
    1/n_valid; ``s`` is the per-instance hinge scale lam/(1-θ)² (no 1/M).
    CPU tensors run the plain version; CUDA tensors launch B6 (counted in
    ``odm_svrg_grad.launches``)."""
    if on_cpu(w, anchor, h, x, y, wt, inv_n,
              kernel="odm_svrg_grad"):
        return odm_svrg_grad_plain(w, anchor, h, x, y, wt, inv_n, s=s,
                                   theta=theta, ups=ups)
    out = launch_odm_svrg_grad(w, anchor, h, x, y, wt, inv_n, s=s,
                               theta=theta, ups=ups)
    odm_svrg_grad.launches.bump()
    return out


odm_svrg_grad.launches = _counter("launch.odm_svrg_grad")


def odm_svrg_epoch(w: Tensor, anchor: Tensor, h: Tensor, xs: Tensor,
                   ys: Tensor, wts: Tensor, inv_n: Tensor, eta: Tensor, *,
                   s: float, theta: float = 0.1, ups: float = 0.5,
                   schedule: str = "serial") -> Tensor:
    """One epoch of inner steps over the (K, S, b, d) minibatch layout of
    ``dsvrg._pad_batches``: ``wts`` (S, b) masks each step's padding,
    ``inv_n`` (S, 1) holds each step's 1/n_valid, ``eta`` is a one-element
    tensor and ``s`` the per-instance hinge scale lam/(1-θ)². ``serial``
    returns the round-robin chain's w (d,), ``parallel`` the K chains'
    last iterates (K, d) (the caller averages them). CPU tensors run the
    plain version; CUDA tensors launch the epoch kernel once (counted in
    ``odm_svrg_epoch.launches``)."""
    if on_cpu(w, anchor, h, xs, ys, wts, inv_n, eta,
              kernel="odm_svrg_epoch"):
        return odm_svrg_epoch_plain(w, anchor, h, xs, ys, wts, inv_n, eta,
                                    s=s, theta=theta, ups=ups,
                                    schedule=schedule)
    out = launch_odm_svrg_epoch(w, anchor, h, xs, ys, wts, inv_n, eta, s=s,
                                theta=theta, ups=ups, schedule=schedule)
    odm_svrg_epoch.launches.bump()
    return out


odm_svrg_epoch.launches = _counter("launch.odm_svrg_epoch")
