"""DSVRG for linear-kernel ODM (paper Algorithm 2, after Lee et al. 2017).

Port of ``repro.core.dsvrg``. Per epoch:

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
once per epoch. The inner loop is the route's hot spot: with
``DSVRGConfig.fused`` unset or True each epoch's inner steps are one call
of :func:`repro_torch.kernels.odm_grad.odm_svrg_epoch` (on the card one
launch of the whole-epoch kernel, the counterpart of the reference's
``lax.scan`` over its fused B6 pass; on the CPU its plain loop);
``fused=False`` keeps the reference's unfused composition step by step
(:func:`repro_torch.core.odm.svrg_direction`,
:func:`repro_torch.core.odm.primal_grad`).

Nothing here reads a device value on the host: the step size ``eta`` is
a 0-d device tensor, each step's 1/n_valid is precomputed once per solve
(the tail mask is static), and the per-epoch objective history stays on
the device until the solve returns. The parallel schedule advances all K
chains together (one CTA per chain in the epoch kernel), which is what
``jax.vmap(chain)`` amounts to on the TPU.

With a fault plan, a tracker or a resume manager the epochs run as
checkpointable segments (:func:`_segmented`): the ``dsvrg.segment`` fault
site before each, the tracker's row and the resume checkpoint after each.
Each segment still runs its epochs through the epoch kernel, one launch
an epoch, and a segmented fit equals the unsegmented one bit for bit.

:func:`_solve_stream` trains from a sharded source that is never
resident: per slab of ``stream_slab`` rows one B7 launch in the anchor
pass and one epoch-kernel launch over the slab's live minibatches in
the inner pass.

SPMD (:func:`_solve_sharded`, :func:`make_sharded_epoch`): the K
partitions are sharded over the ``data`` axis of a ``torch.distributed``
device mesh, K / n_dev a rank, and every rank calls with the same
arguments. The communication is the reference's, pinned by the
``collective.*`` counters of :mod:`repro_torch.sharding`:

* per solve, one ``psum`` of the local ‖x‖² sums for the auto step size
  (so every rank, and the one-process solve, land on the same eta), and
  one broadcast of the partition permutation, drawn on the first rank;
* per epoch, one ``psum`` of the local anchor gradients — the paper's
  single center-node reduction — and one ``psum`` of the local loss sums
  (the objective history is ``psum(loss − ridge) + ridge``, assembled on
  the device); ``schedule="parallel"`` adds one ``pmean`` of the
  ranks' averaged chains;
* ``schedule="serial"``: the slab is gathered ONCE per solve (the
  reference hoists it out of its epoch scan), and every rank runs the
  whole round-robin chain, one epoch-kernel launch an epoch.

Each rank launches B7 over its own slab for the anchor gradient and the
epoch kernel over its own chains (parallel) or the gathered chain
(serial).

Not ported here (ROADMAP): ``epoch_trace_count``/``_TRACE_EVENTS`` (they
pin a JAX trace count; eager PyTorch has no trace; the collective
counters pin the pattern instead) and the legacy warn-once ``solve`` and
``solve_sharded`` shims.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch import sharding as shd
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


def _hinge_kw(params: ODMParams) -> dict:
    """The fused kernels' hinge arguments: the per-instance scale
    s = lam/(1-θ)² (no 1/M), θ and ups."""
    return dict(s=params.lam / (1.0 - params.theta) ** 2,
                theta=params.theta, ups=params.ups)


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
    """One faithful round-robin epoch over xs (K, S, b, d): fused, one
    epoch-kernel launch on the card; unfused, the reference's composition
    step by step."""
    if fused:
        return og.odm_svrg_epoch(w, anchor, h, xs, ys, wts, inv_n, eta,
                                 schedule="serial", **_hinge_kw(params))
    K, S = ys.shape[:2]
    for k in range(K):
        xk, yk = xs[k], ys[k]
        for s in range(S):
            w = w - eta * odm.svrg_direction(w, anchor, h, xk[s], yk[s],
                                             params, wb=wts[s])
    return w


def _epoch_parallel(w: Tensor, xs: Tensor, ys: Tensor, wts: Tensor,
                    inv_n: Tensor, anchor: Tensor, h: Tensor, eta: Tensor,
                    params: ODMParams, fused: bool) -> Tensor:
    """Beyond the paper: K chains from the same anchor, averaged at the
    end (fused: one launch, one CTA per chain; unfused: one batched step
    at a time)."""
    if fused:
        ws = og.odm_svrg_epoch(w, anchor, h, xs, ys, wts, inv_n, eta,
                               schedule="parallel", **_hinge_kw(params))
        return torch.mean(ws, dim=0)
    K, S = ys.shape[:2]
    ws = w.expand(K, -1).contiguous()
    for s in range(S):
        ws = ws - eta * odm.svrg_direction(ws, anchor, h, xs[:, s], ys[:, s],
                                           params, wb=wts[s])
    return torch.mean(ws, dim=0)


def _flatten(xs: Tensor, ys: Tensor, wts: Tensor):
    """(K, S, b, *) batch layout -> flat padded rows + per-row weights."""
    K, S, b = ys.shape
    xf = xs.reshape(K * S * b, -1)
    yf = ys.reshape(K * S * b)
    wf = wts[None].expand(K, S, b).reshape(K * S * b)
    return xf, yf, wf


def _inv_n(wts: Tensor) -> Tensor:
    """Each step's 1/n_valid as an (S, 1) device tensor."""
    return (1.0 / torch.clamp_min(torch.sum(wts, dim=-1), 1.0))[:, None]


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
    # the tail mask is static, so each step's divisor is made once a solve
    inv_n = _inv_n(wts)
    w, hist = w0, []
    for i in range(cfg.epochs):
        with _span("dsvrg.epoch", epoch=i):
            anchor = w
            h = anchor + _loss_grad(anchor, xf, yf, params, M, fused)
            w = epoch_fn(w, xs, ys, wts, inv_n, anchor, h, eta, params,
                         fused)
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

    perm = _partition_perm(x, cfg, K, key)
    xp, yp = x[perm], y[perm]
    xs, ys, wts = _pad_batches(xp.reshape(K, M // K, d),
                               yp.reshape(K, M // K), cfg.batch)
    w0 = torch.zeros(d, dtype=x.dtype, device=x.device) if w0 is None \
        else w0
    if faults is None and tracker is None and resume is None:
        w, hist, eta = _run(w0, xs, ys, wts, params=params, cfg=cfg, M=M)
    else:
        def runner(w, n):
            return _run(w, xs, ys, wts, params=params,
                        cfg=dataclasses.replace(cfg, epochs=n), M=M)

        w, hist, eta = _segmented(runner, w0, cfg, M, perm=perm,
                                  faults=faults, tracker=tracker,
                                  resume=resume)
    return DSVRGResult(w=w, history=hist, perm=perm, eta=eta)


# ---------------------------------------------------------------------------
# streaming solve (out-of-core: consumes a ShardedSource slab by slab)
# ---------------------------------------------------------------------------

def _solve_stream(source, params: ODMParams, cfg: DSVRGConfig, key=None,
                  w0: Tensor | None = None, *,
                  device: str | torch.device, faults=None,
                  tracker=None, resume=None, depth: int = 2, executor=None,
                  metrics=None, accountant=None
                  ) -> tuple[DSVRGResult, Tensor]:
    """Out-of-core DSVRG: epochs stream ``cfg.stream_slab``-row slabs
    from a :class:`repro_torch.data.streaming.sources.ShardedSource`
    through the prefetch loader onto ``device``; the (M, d) matrix is
    never resident.

    Per epoch, two passes over the stream: an anchor pass summing, in
    slab order, each slab's hinge gradient (one B7 launch on the card,
    lam scaled by the slab's share of M), objective part and, on the
    first pass only, ‖x‖² part (the auto step size); then the serial
    SVRG inner chain over the global minibatch sequence, one epoch-kernel
    launch a slab. A terminal pass gives the last objective and
    ``kkt = ‖w + g‖∞``. Slab boundaries are global row indices
    (``iter_slabs``), so every reduction runs in a fixed order: ``w`` is
    bitwise invariant to how the source is sharded, and a kill/resume
    through :class:`~repro_torch.distributed.resume.DsvrgResumeManager`
    equals the uninterrupted run. Relative to the resident solver this is
    the K = 1 stream-order chain (``partition_strategy="identity"``);
    ``n_partitions`` / ``partition_strategy`` are ignored.

    The zero-padded last slab may hold minibatches with no live row. The
    reference masks such a step to ``w − 0·dir = w``; here only the
    slab's ``ceil(n_valid / b)`` live minibatches reach the chain, which
    is the same arithmetic (the epoch kernel has no such mask). Each slab
    reaches the device by a plain synchronous copy, and no device value
    is read on the host inside the slab loops.

    Returns ``(result, kkt)`` with ``result.perm = None`` (a stream has
    no materialized permutation).
    """
    from repro_torch.data.streaming import loader as stream_loader

    M, d = int(source.n_rows), int(source.n_features)
    if M <= 0:
        raise ValueError("streaming solve needs a non-empty source")
    if cfg.schedule != "serial":
        raise ValueError(
            "streaming DSVRG supports schedule='serial' only (the "
            "parallel schedule needs all K chains resident at once); "
            f"got {cfg.schedule!r}")
    del key                      # stream order is the partition order
    device = torch.device(device)
    f32 = torch.float32
    b = min(cfg.batch, M)
    R = -(-max(cfg.stream_slab, b) // b) * b      # slab rows, multiple of b
    fused = _resolve_fused(cfg)

    if metrics is None and tracker is not None:
        from repro_torch.observe.instruments import MetricsRegistry
        metrics = MetricsRegistry()

    def slabs():
        return stream_loader.iter_slabs(
            source, R, depth=depth, executor=executor, metrics=metrics,
            faults=faults, accountant=accountant)

    def to_dev(a) -> Tensor:
        return torch.from_numpy(a).to(device=device, dtype=f32)

    masks: dict[int, tuple[Tensor, Tensor, Tensor]] = {}

    def slab_masks(n_valid: int):
        """(row weights (R,), live steps' weights (live, b), their
        1/n_valid (live, 1)) — made once a solve for each of the (at
        most two) slab fills."""
        if n_valid not in masks:
            wf = (torch.arange(R, device=device) < n_valid).to(f32)
            wts = wf[:-(-n_valid // b) * b].reshape(-1, b)
            inv_n = (1.0 / torch.clamp_min(torch.sum(wts, dim=-1),
                                           1.0))[:, None]
            masks[n_valid] = (wf, wts, inv_n)
        return masks[n_valid]

    def anchor_pass(anchor: Tensor, want_sq: bool):
        g = torch.zeros(d, dtype=f32, device=device)
        loss = torch.zeros((), dtype=f32, device=device)
        sq = torch.zeros((), dtype=f32, device=device)
        ridge = 0.5 * anchor @ anchor
        with _span("dsvrg.stream.anchor"):
            for slab in slabs():
                xf, yf = to_dev(slab.x), to_dev(slab.y)
                wf = slab_masks(slab.n_valid)[0]
                g = g + _loss_grad(anchor, xf, yf, params, M, fused)
                loss = loss + (odm.primal_objective(
                    anchor, xf, yf, params, weights=wf, total=M) - ridge)
                if want_sq:
                    sq = sq + torch.sum(wf * torch.sum(xf * xf, dim=-1))
        return g, loss, sq

    def inner_pass(w: Tensor, anchor: Tensor, h: Tensor, eta: Tensor):
        with _span("dsvrg.stream.inner"):
            for slab in slabs():
                _, wts, inv_n = slab_masks(slab.n_valid)
                live = wts.shape[0]
                xs = to_dev(slab.x[:live * b]).reshape(1, live, b, d)
                ys = to_dev(slab.y[:live * b]).reshape(1, live, b)
                w = _epoch_serial(w, xs, ys, wts, inv_n, anchor, h, eta,
                                  params, fused)
        return w

    eta_box: list = [torch.tensor(cfg.eta, dtype=f32, device=device)
                     if cfg.eta > 0 else None]
    kkt_box: list = [torch.zeros((), dtype=f32, device=device)]

    def runner(w: Tensor, n: int):
        """n epochs from iterate w -> (w', hist_n, eta), the _segmented
        contract. History entry e is obj(w after epoch e), read off the
        next epoch's anchor pass (or the terminal pass for the last)."""
        if n <= 0:
            eta0 = eta_box[0] if eta_box[0] is not None else \
                torch.zeros((), dtype=f32, device=device)
            return w, w.new_zeros(0), eta0
        hist = []
        for e in range(n):
            anchor = w
            g, loss, sq = anchor_pass(anchor, eta_box[0] is None)
            if eta_box[0] is None:
                eta_box[0] = _eta_from_sumsq(sq, params, M).to(f32)
            if e > 0:
                hist.append(0.5 * anchor @ anchor + loss)
            w = inner_pass(w, anchor, anchor + g, eta_box[0])
        g, loss, _ = anchor_pass(w, False)
        hist.append(0.5 * w @ w + loss)
        kkt_box[0] = torch.max(torch.abs(w + g))
        return w, torch.stack(hist), eta_box[0]

    w0 = torch.zeros(d, dtype=f32, device=device) if w0 is None else w0
    if faults is None and tracker is None and resume is None:
        w, hist, eta = runner(w0, cfg.epochs)
    else:
        w, hist, eta = _segmented(
            runner, w0, cfg, M,
            perm=torch.zeros(0, dtype=torch.int64, device=device),
            faults=faults, tracker=tracker, resume=resume)
    if metrics is not None and tracker is not None:
        metrics.drain(tracker, step=cfg.epochs)
    return DSVRGResult(w=w, history=hist, perm=None, eta=eta), kkt_box[0]


# ---------------------------------------------------------------------------
# SPMD: partitions sharded over the mesh's data axis
# ---------------------------------------------------------------------------

def _gather_slab(xs: Tensor, ys: Tensor, mesh,
                 data_axis: str) -> tuple[Tensor, Tensor]:
    """The (K, S, b, ·) partition slab of every rank, on every rank: one
    tiled all-gather of x and y packed side by side."""
    d = xs.shape[-1]
    full = shd.all_gather(torch.cat([xs, ys[..., None]], dim=-1), mesh,
                          data_axis)
    return full[..., :d].contiguous(), full[..., d].contiguous()


def _sharded_eta(xs: Tensor, ys: Tensor, wts: Tensor, params: ODMParams,
                 cfg: DSVRGConfig, M: int, mesh, data_axis: str,
                 eta: float | None) -> Tensor:
    """The step size on a mesh. An explicit ``eta`` wins, then
    ``cfg.eta > 0``; otherwise the auto step from a ``psum`` of the local
    ‖x‖² sums, the one-process solve's value."""
    if eta is not None:
        return torch.tensor(eta, dtype=xs.dtype, device=xs.device)
    if cfg.eta > 0:
        return torch.tensor(cfg.eta, dtype=xs.dtype, device=xs.device)
    xf, _, wf = _flatten(xs, ys, wts)
    sumsq = shd.psum(torch.sum(wf * torch.sum(xf * xf, dim=-1)), mesh,
                     data_axis)
    return _eta_from_sumsq(sumsq, params, M).to(xs.dtype)


def _sharded_epoch(w: Tensor, xs: Tensor, ys: Tensor, wts: Tensor,
                   inv_n: Tensor, eta: Tensor, params: ODMParams,
                   cfg: DSVRGConfig, M: int, mesh, data_axis: str,
                   fused: bool, gathered: tuple[Tensor, Tensor] | None = None
                   ) -> tuple[Tensor, Tensor]:
    """One epoch on this rank's slab xs (K_loc, S, b, d) -> (w', the
    GLOBAL objective). Step 1's full gradient is a ``psum``; step 2
    follows ``cfg.schedule``; the objective is the ``psum`` of the local
    loss sums plus one ridge term. ``gathered``: the serial schedule's
    whole slab, gathered once per solve by the caller."""
    anchor = w
    xf, yf, wf = _flatten(xs, ys, wts)
    g_local = _loss_grad(anchor, xf, yf, params, M, fused)
    h = shd.psum(g_local, mesh, data_axis) + anchor
    if cfg.schedule == "parallel":
        wk = _epoch_parallel(w, xs, ys, wts, inv_n, anchor, h, eta, params,
                             fused)
        w = shd.pmean(wk, mesh, data_axis)
    else:
        xg, yg = gathered if gathered is not None else \
            _gather_slab(xs, ys, mesh, data_axis)
        w = _epoch_serial(w, xg, yg, wts, inv_n, anchor, h, eta, params,
                          fused)
    ridge = 0.5 * w @ w
    loss_local = odm.primal_objective(w, xf, yf, params, weights=wf,
                                      total=M) - ridge
    return w, shd.psum(loss_local, mesh, data_axis) + ridge


def _sharded_run(w0: Tensor, xs: Tensor, ys: Tensor, wts: Tensor, eta,
                 gathered, *, params: ODMParams, cfg: DSVRGConfig, M: int,
                 mesh, data_axis: str) -> tuple[Tensor, Tensor, Tensor]:
    """``cfg.epochs`` epochs from ``w0`` on this rank's slab -> (w,
    history, eta): the reference's ``_make_sharded_run``. The step size
    and the serial schedule's gathered slab are made once a solve by the
    caller and passed in."""
    fused = _resolve_fused(cfg)
    inv_n = _inv_n(wts)
    w, hist = w0, []
    for i in range(cfg.epochs):
        with _span("dsvrg.epoch", epoch=i):
            w, obj = _sharded_epoch(w, xs, ys, wts, inv_n, eta, params, cfg,
                                    M, mesh, data_axis, fused, gathered)
        hist.append(obj)
    history = torch.stack(hist) if hist else xs.new_zeros(0)
    return w, history, eta


def make_sharded_epoch(mesh, params: ODMParams, cfg: DSVRGConfig, M: int,
                       data_axis: str = "data", eta: float | None = None):
    """A single-epoch function over partitions sharded on ``data_axis``:
    ``(w, xs, ys) -> (w', obj_global)``, with xs (K, m, d) and ys (K, m)
    the WHOLE partition layout (the same on every rank; each rank takes
    its slab of K / n_dev partitions). A validation helper: solves go
    through :func:`_solve_sharded`. Without ``eta`` and with
    ``cfg.eta <= 0`` the step size is the auto step from the sharded data
    (a ``psum`` of the local ‖x‖² sums), the one-process solve's."""
    fused = _resolve_fused(cfg)
    n_dev = shd.axis_size(mesh, data_axis)
    r = shd.axis_index(mesh, data_axis)
    dev = shd.mesh_device(mesh)

    def epoch(w: Tensor, xs: Tensor, ys: Tensor):
        Kl = xs.shape[0] // n_dev
        xsb, ysb, wts = _pad_batches(xs[r * Kl:(r + 1) * Kl].to(dev),
                                     ys[r * Kl:(r + 1) * Kl].to(dev),
                                     cfg.batch)
        eta_v = _sharded_eta(xsb, ysb, wts, params, cfg, M, mesh,
                             data_axis, eta)
        return _sharded_epoch(w.to(dev), xsb, ysb, wts, _inv_n(wts), eta_v,
                              params, cfg, M, mesh, data_axis, fused)

    return epoch


def _solve_sharded(x: Tensor, y: Tensor, params: ODMParams,
                   cfg: DSVRGConfig, key, mesh, data_axis: str = "data",
                   w0: Tensor | None = None, *, faults=None, tracker=None,
                   resume=None) -> DSVRGResult:
    """SPMD DSVRG over ``mesh[data_axis]`` (the module docs). Every rank
    calls it with the same arguments and returns the same replicated
    result on its own device; x and y may lie on the host, and a rank then
    moves only its slab (and, on the serial schedule, the gathered one)
    to its device. The permutation is drawn on the mesh's first rank and
    broadcast. ``faults``/``tracker``/``resume`` run the epochs as
    segments (:func:`_segmented`); checkpoints are committed by the
    first rank alone."""
    M, d = x.shape
    K = cfg.n_partitions
    n_dev = shd.axis_size(mesh, data_axis)
    if M % K != 0:
        raise ValueError(f"K={K} must divide M={M}")
    if K % n_dev != 0:
        raise ValueError(f"K={K} must be a multiple of data axis size {n_dev}")
    if cfg.schedule not in ("serial", "parallel"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    dev = shd.mesh_device(mesh)
    if shd.is_mesh_rank0(mesh):
        perm = _partition_perm(x, cfg, K, key).to(dev, torch.int64)
    else:
        perm = torch.empty(M, dtype=torch.int64, device=dev)
    perm = shd.broadcast(perm, mesh)
    if resume is not None:
        resume.bind(mesh)
    m, Kl = M // K, K // n_dev
    r = shd.axis_index(mesh, data_axis)
    mine = perm[r * Kl * m:(r + 1) * Kl * m].to(x.device)
    xs, ys, wts = _pad_batches(x[mine].reshape(Kl, m, d).to(dev),
                               y[mine].reshape(Kl, m).to(dev), cfg.batch)
    eta = _sharded_eta(xs, ys, wts, params, cfg, M, mesh, data_axis, None)
    gathered = _gather_slab(xs, ys, mesh, data_axis) \
        if cfg.schedule == "serial" else None
    w0 = torch.zeros(d, dtype=x.dtype, device=dev) if w0 is None \
        else w0.to(dev)

    def runner(w, n):
        return _sharded_run(w, xs, ys, wts, eta, gathered, params=params,
                            cfg=dataclasses.replace(cfg, epochs=n), M=M,
                            mesh=mesh, data_axis=data_axis)

    if faults is None and tracker is None and resume is None:
        w, hist, eta = runner(w0, cfg.epochs)
    else:
        w, hist, eta = _segmented(runner, w0, cfg, M, perm=perm,
                                  faults=faults, tracker=tracker,
                                  resume=resume)
    return DSVRGResult(w=w, history=hist, perm=perm, eta=eta)


# ---------------------------------------------------------------------------
# segmented epochs (the instrumented path)
# ---------------------------------------------------------------------------

def _segmented(runner, w0: Tensor, cfg: DSVRGConfig, M: int, *,
               perm: Tensor, faults=None, tracker=None, resume=None):
    """Run ``cfg.epochs`` as checkpointable segments through
    ``runner(w, n) -> (w', hist_n, eta)``, ``resume.segment`` epochs each
    (one without a resume manager). SVRG re-anchors at every epoch start,
    so the iterate alone restarts the next epoch exactly and splitting
    never changes the math: a resumed run and an uninterrupted one are
    bit-identical by construction.

    A resume directory's latest ``{w, history}`` + ``{epoch, eta}``
    restarts the loop at its epoch. Between segments: the
    ``"dsvrg.segment"`` fault site fires (before), the tracker logs
    ``(epoch, objective, eta, wall_s, rows_per_s)`` and the resume
    manager checkpoints ``{w, history, perm}`` + ``{epoch, eta}`` (after)
    — the only host reads of the solve.
    """
    w, done, parts = w0, 0, []
    eta = torch.zeros((), dtype=w0.dtype, device=w0.device)
    seg = resume.segment if resume is not None else 1
    if resume is not None:
        restored = resume.restore(device=w0.device)
        if restored is not None:
            w, done = restored.w, restored.epoch
            parts = [restored.history]
            eta = torch.tensor(restored.eta, dtype=w0.dtype,
                               device=w0.device)
    while done < cfg.epochs:
        if faults is not None:
            faults.site("dsvrg.segment", epoch=done)
        n = min(seg, cfg.epochs - done)
        t0 = time.perf_counter()
        with _span("dsvrg.segment", epoch=done, epochs=n):
            w, h, eta = runner(w, n)
        parts.append(h)
        done += n
        if tracker is not None:
            if w.is_cuda:
                torch.cuda.synchronize(w.device)
            wall = time.perf_counter() - t0
            tracker.log_metrics(done, {
                "route": "dsvrg", "epoch": done, "objective": float(h[-1]),
                "eta": float(eta), "wall_s": wall,
                "rows_per_s": n * M / max(wall, 1e-9)})
        if resume is not None:
            resume.save_segment(epoch=done, w=w, history=torch.cat(parts),
                                perm=perm, eta=eta)
    hist = torch.cat(parts) if parts else w0.new_zeros(0)
    return w, hist, eta
