"""DSVRG for linear-kernel ODM (paper Algorithm 2, after Lee et al. 2017).

Port of the single-process half of ``repro.core.dsvrg``. Per epoch:

1. the full gradient h at the anchor (the epoch's starting iterate) over
   every partition — one fused pass over X (B7 on the card,
   :func:`repro_torch.kernels.odm_grad.odm_grad`);
2. SVRG inner updates ``w <- w - eta * (g_i(w) - g_i(anchor) + h)``:
   ``schedule="serial"`` walks the K partitions in a round-robin chain,
   each consuming its minibatches without replacement and handing w on;
   ``schedule="parallel"`` advances K chains from the same anchor and
   averages them at the epoch's end.

Every partition is pre-sliced into ceil(m/batch) minibatches with a mask
on the ragged tail (:func:`_pad_batches`), so each sample is consumed
once per epoch. The inner direction is the route's hot spot: with
``DSVRGConfig.fused`` unset or True it is one fused pass (B6 on the card,
its plain version on the CPU); ``fused=False`` keeps the reference's
unfused composition (:func:`repro_torch.core.odm.svrg_direction`,
:func:`repro_torch.core.odm.primal_grad`).

The reference runs all epochs in one ``lax.scan``; here the scans are
Python loops that only enqueue device work. Nothing in them reads a device
value on the host: the step size ``eta`` is a 0-d device tensor, each
step's 1/n_valid is precomputed once per solve (the tail mask is static),
and the per-epoch objective history stays on the device until the solve
returns. The parallel schedule advances all K chains in ONE launch per
step, which is what ``jax.vmap(chain)`` amounts to on the TPU.

Not ported here (ROADMAP): ``epoch_trace_count``/``_TRACE_EVENTS`` (they
pin a JAX trace count; eager PyTorch has no trace), the streaming solve
``_solve_stream`` (A14), the multi-device ``_solve_sharded`` and
``make_sharded_epoch`` (A13), and the legacy warn-once ``solve`` shim. The
``faults``/``resume`` seams raise (A12).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch.core import kernel_fns as kf
from repro_torch.core import odm
from repro_torch.core import partition as part_mod
from repro_torch.core.odm import ODMParams
from repro_torch.kernels import odm_grad as og
from repro_torch.observe.spans import span as _span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DSVRGConfig:
    """Knobs of the DSVRG route — the reference's fields and defaults."""

    n_partitions: int = 8
    n_landmarks: int = 8
    epochs: int = 10
    eta: float = 0.0                # <= 0: auto = 0.5 / L_hat (auto_eta)
    batch: int = 1                  # inner minibatch size (1 = the paper's)
    schedule: str = "serial"        # serial | parallel
    partition_strategy: str = "stratified"
    fused: bool | None = None       # None: the fused direction (B6 / B7 on
    #                                 the card, their plain versions on CPU)
    coreset_frac: float = 0.1       # the csvrg baseline route's (A10)
    stream_slab: int = 4096         # the streaming solve's (A14)


def auto_eta(x: Tensor, params: ODMParams, frac: float = 0.5) -> float:
    """Step size from the smoothness of the per-instance objective:
    L_hat = 1 + s·E||x||² with s = lam/(1-theta)². Host-side convenience;
    the solver evaluates the same formula on the device."""
    return float(_eta_from_sumsq(torch.sum(x * x), params, x.shape[0], frac))


def _eta_from_sumsq(sumsq: Tensor, params: ODMParams, M: int,
                    frac: float = 0.5) -> Tensor:
    s = params.lam / (1.0 - params.theta) ** 2
    return frac / (1.0 + s * sumsq / M)


class DSVRGResult(NamedTuple):
    w: Tensor
    history: Tensor          # (epochs,) primal objective after each epoch
    perm: Tensor
    eta: Tensor | float = 0.0   # step size actually used (auto or cfg.eta)


def _resolve_fused(cfg: DSVRGConfig) -> bool:
    """``None`` means the fused direction: the kernels on CUDA tensors,
    their plain versions on CPU tensors (the reference picks its jnp form
    under interpret mode instead; both forms compute the same thing)."""
    return True if cfg.fused is None else cfg.fused


# ---------------------------------------------------------------------------
# batched-epoch building blocks
# ---------------------------------------------------------------------------

def _pad_batches(xs: Tensor, ys: Tensor,
                 batch: int) -> tuple[Tensor, Tensor, Tensor]:
    """xs (K, m, d), ys (K, m) -> xs (K, S, b, d), ys (K, S, b), wts (S, b)
    with S = ceil(m / b); padded rows have x = 0, y = 0 and weight 0."""
    K, m, d = xs.shape
    b = min(batch, m)
    S = -(-m // b)
    pad = S * b - m
    xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
    ys = torch.nn.functional.pad(ys, (0, pad))
    wts = (torch.arange(S * b, device=xs.device) < m).to(xs.dtype)
    return xs.reshape(K, S, b, d), ys.reshape(K, S, b), wts.reshape(S, b)


def _direction(w: Tensor, anchor: Tensor, h: Tensor, xb: Tensor, yb: Tensor,
               wb: Tensor, inv_n: Tensor, params: ODMParams,
               fused: bool) -> Tensor:
    """One inner step's g_w − g_a + h (of one chain, or of C at once)."""
    if fused:
        return og.odm_svrg_grad(w, anchor, h, xb, yb, wb, inv_n,
                                s=params.lam / (1.0 - params.theta) ** 2,
                                theta=params.theta, ups=params.ups)
    return odm.svrg_direction(w, anchor, h, xb, yb, params, wb=wb)


def _loss_grad(anchor: Tensor, xf: Tensor, yf: Tensor, params: ODMParams,
               M: int, fused: bool) -> Tensor:
    """Hinge part of the full gradient over (possibly padded) rows, scaled
    by the TRUE count M; padded rows (x = 0, y = 0) contribute nothing.
    The caller adds the ridge term (the anchor itself)."""
    if fused:
        g = og.odm_grad(anchor, xf, yf, lam=params.lam * xf.shape[0] / M,
                        theta=params.theta, ups=params.ups)
    else:
        g = odm.primal_grad(anchor, xf, yf, params, total=M)
    return g - anchor


def _epoch_serial(w: Tensor, xs: Tensor, ys: Tensor, wts: Tensor,
                  inv_n: Tensor, anchor: Tensor, h: Tensor, eta: Tensor,
                  params: ODMParams, fused: bool) -> Tensor:
    """One faithful round-robin epoch over xs (K, S, b, d)."""
    K, S = ys.shape[:2]
    for k in range(K):
        xk, yk = xs[k], ys[k]
        for s in range(S):
            w = w - eta * _direction(w, anchor, h, xk[s], yk[s], wts[s],
                                     inv_n[s], params, fused)
    return w


def _epoch_parallel(w: Tensor, xs: Tensor, ys: Tensor, wts: Tensor,
                    inv_n: Tensor, anchor: Tensor, h: Tensor, eta: Tensor,
                    params: ODMParams, fused: bool) -> Tensor:
    """Beyond the paper: K chains from the same anchor, one batched step
    at a time, averaged at the end."""
    K, S = ys.shape[:2]
    ws = w.expand(K, -1).contiguous()
    for s in range(S):
        ws = ws - eta * _direction(ws, anchor, h, xs[:, s], ys[:, s], wts[s],
                                   inv_n[s], params, fused)
    return torch.mean(ws, dim=0)


def _flatten(xs: Tensor, ys: Tensor, wts: Tensor):
    """(K, S, b, *) batch layout -> flat padded rows + per-row weights."""
    K, S, b = ys.shape
    xf = xs.reshape(K * S * b, -1)
    yf = ys.reshape(K * S * b)
    wf = wts[None].expand(K, S, b).reshape(K * S * b)
    return xf, yf, wf


def _partition_perm(x: Tensor, cfg: DSVRGConfig, K: int, key) -> Tensor:
    M = x.shape[0]
    if cfg.partition_strategy == "identity":
        # stream-order chain: rows stay where they are (the reference's
        # parity hook; a test injects the reference's perm this way)
        return torch.arange(M, device=x.device)
    if cfg.partition_strategy == "stratified":
        # linear kernel: strata in input space (phi = identity)
        plan = part_mod.make_plan(kf.KernelSpec(name="linear"), x,
                                  cfg.n_landmarks, K, key)
        return plan.perm
    return part_mod.random_partitions(M, K, key, device=x.device)


# ---------------------------------------------------------------------------
# single-process solve
# ---------------------------------------------------------------------------

def _run(w0: Tensor, xs: Tensor, ys: Tensor, wts: Tensor, *,
         params: ODMParams, cfg: DSVRGConfig,
         M: int) -> tuple[Tensor, Tensor, Tensor]:
    """``cfg.epochs`` epochs from ``w0`` -> (w, history, eta), all on the
    device of ``xs`` and without a host read."""
    fused = _resolve_fused(cfg)
    epoch_fn = _epoch_serial if cfg.schedule == "serial" else _epoch_parallel
    xf, yf, wf = _flatten(xs, ys, wts)
    if cfg.eta > 0:
        eta = torch.tensor(cfg.eta, dtype=xs.dtype, device=xs.device)
    else:
        eta = _eta_from_sumsq(torch.sum(wf * torch.sum(xf * xf, dim=-1)),
                              params, M).to(xs.dtype)
    # each step's 1/n_valid (the divisor of svrg_direction) as an (S, 1)
    # device tensor: the tail mask is static, so once per solve
    inv_n = (1.0 / torch.clamp_min(torch.sum(wts, dim=-1), 1.0))[:, None]
    w, hist = w0, []
    for _ in range(cfg.epochs):
        anchor = w
        h = anchor + _loss_grad(anchor, xf, yf, params, M, fused)
        w = epoch_fn(w, xs, ys, wts, inv_n, anchor, h, eta, params, fused)
        hist.append(odm.primal_objective(w, xf, yf, params, weights=wf,
                                         total=M))
    history = torch.stack(hist) if hist else xs.new_zeros(0)
    return w, history, eta


def _solve(x: Tensor, y: Tensor, params: ODMParams, cfg: DSVRGConfig,
           key=None, w0: Tensor | None = None, *, faults=None,
           tracker=None, resume=None) -> DSVRGResult:
    """Single-process DSVRG on the device of ``x``. ``key`` seeds the
    partitioning (a ``torch.Generator`` or an int, as in ``sodm``)."""
    M, d = x.shape
    K = cfg.n_partitions
    if M % K != 0:
        raise ValueError(f"K={K} must divide M={M}")
    if cfg.schedule not in ("serial", "parallel"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if faults is not None or resume is not None:
        raise NotImplementedError(
            "faults/resume seams are not ported yet (ROADMAP A12)")

    perm = _partition_perm(x, cfg, K, key)
    xp, yp = x[perm], y[perm]
    xs, ys, wts = _pad_batches(xp.reshape(K, M // K, d),
                               yp.reshape(K, M // K), cfg.batch)
    w0 = torch.zeros(d, dtype=x.dtype, device=x.device) if w0 is None \
        else w0
    if tracker is None:
        w, hist, eta = _run(w0, xs, ys, wts, params=params, cfg=cfg, M=M)
    else:
        def runner(w, n):
            return _run(w, xs, ys, wts, params=params,
                        cfg=dataclasses.replace(cfg, epochs=n), M=M)

        w, hist, eta = _segmented(runner, w0, cfg, M, tracker=tracker)
    return DSVRGResult(w=w, history=hist, perm=perm, eta=eta)


# ---------------------------------------------------------------------------
# segmented epochs (the instrumented path)
# ---------------------------------------------------------------------------

def _segmented(runner, w0: Tensor, cfg: DSVRGConfig, M: int, *, tracker):
    """Run ``cfg.epochs`` as segments of one epoch each through
    ``runner(w, n) -> (w', hist_n, eta)``. SVRG re-anchors at every epoch
    start, so the iterate alone restarts the next epoch exactly and
    splitting never changes the math. After each segment the tracker logs
    ``(epoch, objective, eta, wall_s, rows_per_s)`` — the only host reads
    of the solve. The reference's ``faults``/``resume`` seams here are
    ROADMAP A12 (``_solve`` raises for them)."""
    w, done, parts = w0, 0, []
    eta = torch.zeros((), dtype=w0.dtype, device=w0.device)
    while done < cfg.epochs:
        t0 = time.perf_counter()
        with _span("dsvrg.segment", epoch=done, epochs=1):
            w, h, eta = runner(w, 1)
        parts.append(h)
        done += 1
        if w.is_cuda:
            torch.cuda.synchronize(w.device)
        wall = time.perf_counter() - t0
        tracker.log_metrics(done, {
            "route": "dsvrg", "epoch": done, "objective": float(h[-1]),
            "eta": float(eta), "wall_s": wall,
            "rows_per_s": M / max(wall, 1e-9)})
    hist = torch.cat(parts) if parts else w0.new_zeros(0)
    return w, hist, eta
