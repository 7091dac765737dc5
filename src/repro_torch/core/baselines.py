"""Baseline scalable QP solvers the paper compares against (Section 4).

Port of ``repro.core.baselines``. Every baseline trains the same ODM dual,
so accuracy differences reflect the partition / merge strategy:

* **Ca-ODM** — the cascade (Graf et al. 2004): each node solves its local
  ODM exactly and forwards its top half by dual magnitude; pairs merge
  back to the node size. On the card a level's node Grams take one B8
  launch (``ops.gram``) and its node solves one K4 launch
  (``dual_cd.solve``).
* **DiP-ODM** — k-means clusters as the strata of the stratified deal,
  then the SODM merge.
* **DC-ODM** — k-means clusters as the partitions, then the SODM merge.
* **ODM_svrg** — single-chain SVRG (Johnson & Zhang 2013) on the linear
  primal.
* **ODM_csvrg** — coreset SVRG (Tan et al. 2019): the anchor gradient on a
  k-center coreset.

The gradient baselines take the port's fused kernels: an epoch's inner
steps ``w ← w − eta (g_w − g_a + h)`` are one launch of the epoch kernel
(``odm_grad.odm_svrg_epoch``, each step B6's arithmetic; algebraically
``minibatch_grad(w) − minibatch_grad(a) + h``) and the anchor gradient
one B7 launch (``ops.odm_grad``, over x or the coreset). Their epoch loop
reads no device value: eta is a 0-d device tensor, each epoch's
minibatches are gathered in one pass, as in
:mod:`repro_torch.core.dsvrg`.

Random draws come from a ``torch.Generator``; the parity tests inject the
reference's draws instead (``perm=`` for the cascade, dip and dc,
``_perms=`` for the per-epoch permutations of svrg and csvrg).

The cascade also trains from a sharded source that is never resident
(:func:`_cascade_solve_stream`): leaves solve as the shards arrive, each
node one B8 and one K4 launch.

Not ported here: the warn-once legacy shims (``cascade_solve``,
``dip_solve``, ``dc_solve``, ``svrg_solve``, ``csvrg_solve``) and
``cascade_predict``: the port has no legacy callers (serve through
``serve.model.from_cascade``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Sequence

import torch

from repro_torch.core import dsvrg as dsvrg_mod
from repro_torch.core import dual_cd, kernel_fns as kf
from repro_torch.core import odm
from repro_torch.core import partition as part_mod
from repro_torch.core import sodm as sodm_mod
from repro_torch.core.odm import ODMParams
from repro_torch.kernels import odm_grad as og
from repro_torch.kernels import ops

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Ca-ODM (Cascade)
# ---------------------------------------------------------------------------

class CascadeResult(NamedTuple):
    x_sv: Tensor
    y_sv: Tensor
    alpha: Tensor
    levels_run: int


def _top_support(x: Tensor, y: Tensor, alpha: Tensor,
                 keep: int) -> tuple[Tensor, Tensor, Tensor]:
    """Keep the ``keep`` instances with the largest activity
    |zeta − beta| + min(zeta, beta), batched over a leading node axis.

    ``jax.lax.top_k`` breaks ties by the lower index, and many instances
    tie at exactly 0, so ties decide the survivors: a stable descending
    sort keeps the lower index first, as top_k does (``torch.topk``
    promises no order on ties)."""
    m = x.shape[-2]
    zeta, beta = alpha[..., :m], alpha[..., m:]
    mag = torch.abs(zeta - beta) + torch.minimum(zeta, beta)
    idx = torch.sort(mag, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :keep]
    xs = torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))
    return (xs, torch.gather(y, -1, idx),
            torch.cat([torch.gather(zeta, -1, idx),
                       torch.gather(beta, -1, idx)], dim=-1))


def _cascade_solve(spec: kf.KernelSpec, x: Tensor, y: Tensor,
                   params: ODMParams, levels: int, key=None,
                   tol: float = 1e-4, max_sweeps: int = 100,
                   perm: Tensor | None = None, *,
                   tracker=None) -> CascadeResult:
    """Binary cascade: 2^levels leaves; each merge keeps half of every
    node (the classic funnel) and re-solves on the survivors, warm-started
    from their duals (no ray rescale, as in the reference). ``perm``
    injects the leaf layout; otherwise a random permutation from ``key``
    (a ``torch.Generator`` or an int seed). ``tracker`` (anything with
    ``log_metrics(step, dict)``) receives each level's K, m, worst sweep
    count, worst KKT and seconds — one host read per level."""
    M = x.shape[0]
    K = 2 ** levels
    if M % K != 0:
        raise ValueError(f"2^levels={K} must divide M={M}")
    if perm is None:
        perm = part_mod.random_partitions(M, K, key, device=x.device)
    m = M // K
    xs = x[perm].reshape(K, m, -1)
    ys = y[perm].reshape(K, m)
    alphas = None                      # the zero start at the leaves
    lvl = 0
    while True:
        t0 = time.perf_counter()
        Q = ops.gram(xs, None, spec, yx=ys)
        res = dual_cd.solve(Q, params, mscale=float(m), alpha0=alphas,
                            tol=tol, max_sweeps=max_sweeps)
        alphas = res.alpha
        del Q
        if tracker is not None:
            tracker.log_metrics(lvl + 1, {
                "route": "cascade", "level": levels - lvl,
                "K": xs.shape[0], "m": m,
                "sweeps": int(torch.max(res.sweeps)),
                "kkt": float(torch.max(res.kkt)),
                "wall_s": time.perf_counter() - t0})
        lvl += 1
        if xs.shape[0] == 1:
            break
        # funnel: each node keeps its top m//2, pairs merge back to
        # 2 * (m//2)-sized problems (odd m shrinks by one)
        keep = m // 2
        xk, yk, ak = _top_support(xs, ys, alphas, keep)
        Kn = xs.shape[0] // 2
        m = 2 * keep
        xs = xk.reshape(Kn, m, -1)
        ys = yk.reshape(Kn, m)
        alphas = sodm_mod.merge_alphas(ak.reshape(Kn, 2, 2 * keep))
    return CascadeResult(x_sv=xs[0], y_sv=ys[0], alpha=alphas[0],
                         levels_run=lvl)


def _cascade_solve_stream(spec: kf.KernelSpec, source, params: ODMParams,
                          levels: int, key=None, tol: float = 1e-4,
                          max_sweeps: int = 100, *,
                          device: str | torch.device, faults=None,
                          tracker=None, resume=None, depth: int = 2,
                          executor=None, metrics=None,
                          accountant=None) -> CascadeResult:
    """Out-of-core cascade: level-0 leaves train as the shards arrive.

    The cascade runs as an online binary tournament: each arriving leaf
    (one ``M / 2^levels``-row slab of the stream, cut on global row
    indices by ``iter_slabs`` and copied to ``device``) is solved at
    once, and whenever two same-tier survivors sit on top of the merge
    stack they funnel — keep the top half of each (:func:`_top_support`),
    concatenate, warm-start from the merged duals
    (:func:`repro_torch.core.sodm.merge_alphas`) and re-solve. At most
    ``levels + 1`` partially merged nodes are ever resident. Each node
    solve is one B8 launch for its signed Gram (``ops.gram``) and one K4
    launch (``dual_cd.solve``), K = 1 each.

    With the dense solver given ``perm = arange(M)`` the tournament pairs
    the same instances into the same nodes. Leaves stream in stream
    order; ``key`` is accepted for signature parity and unused.

    Instrumentation: the ``cascade.shard`` fault site fires per leaf
    (``data.prefetch`` fires underneath, inside the loader), a
    ``cascade.shard`` span wraps each leaf's solve and merges, the
    tracker logs per-leaf throughput (one synchronize a leaf), and
    ``resume`` (a :class:`~repro_torch.distributed.resume
    .CascadeResumeManager`) checkpoints the merge stack after each leaf,
    so a restart re-enters the stream at the first unprocessed leaf
    without reading completed shards again.
    """
    from repro_torch.data.streaming import loader as stream_loader
    from repro_torch.observe.spans import span as _span

    M = int(source.n_rows)
    K = 2 ** levels
    if M % K != 0:
        raise ValueError(f"2^levels={K} must divide M={M}")
    del key
    device = torch.device(device)
    m0 = M // K
    if metrics is None and tracker is not None:
        from repro_torch.observe.instruments import MetricsRegistry
        metrics = MetricsRegistry()

    def solve_node(xn: Tensor, yn: Tensor, a0: Tensor | None) -> Tensor:
        Q = ops.gram(xn[None], None, spec, yx=yn[None])
        return dual_cd.solve(Q[0], params, mscale=float(xn.shape[0]),
                             alpha0=a0, tol=tol,
                             max_sweeps=max_sweeps).alpha

    # merge stack: (tier, x (m, d), y (m,), alpha (2m,)) — tier t holds
    # the solved merge of 2^t consecutive leaves
    stack: list[tuple[int, Tensor, Tensor, Tensor]] = []
    start_leaf = 0
    if resume is not None:
        restored = resume.restore_stream(device=device)
        if restored is not None:
            start_leaf, stack = restored.leaf, list(restored.stack)

    def funnel():
        while len(stack) >= 2 and stack[-1][0] == stack[-2][0]:
            tier, xb, yb, ab = stack.pop()
            _, xa, ya, aa = stack.pop()
            keep = int(xa.shape[0]) // 2
            xa, ya, aa = _top_support(xa, ya, aa, keep)
            xb, yb, ab = _top_support(xb, yb, ab, keep)
            xm = torch.cat([xa, xb])
            ym = torch.cat([ya, yb])
            am = sodm_mod.merge_alphas(torch.stack([aa, ab]))
            stack.append((tier + 1, xm, ym, solve_node(xm, ym, am)))

    slabs = stream_loader.iter_slabs(
        source, m0, start_row=start_leaf * m0, depth=depth,
        executor=executor, metrics=metrics, faults=faults,
        accountant=accountant)
    for slab in slabs:
        leaf = slab.start // m0
        if faults is not None:
            faults.site("cascade.shard", shard=leaf)
        t0 = time.perf_counter()
        with _span("cascade.shard", shard=leaf, rows=m0):
            xl = torch.from_numpy(slab.x).to(device=device,
                                             dtype=torch.float32)
            yl = torch.from_numpy(slab.y).to(device=device,
                                             dtype=torch.float32)
            al = solve_node(xl, yl, None)     # the zero start
            stack.append((0, xl, yl, al))
            funnel()
        if tracker is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            tracker.log_metrics(leaf + 1, {
                "route": "cascade", "leaf": leaf, "rows": m0,
                "wall_s": wall, "rows_per_s": m0 / max(wall, 1e-9)})
        if resume is not None:
            resume.save_stream(leaf=leaf + 1, stack=stack)
    if len(stack) != 1:               # K is a power of two: cannot happen
        raise RuntimeError(f"merge stack did not collapse: {len(stack)}")
    if metrics is not None and tracker is not None:
        metrics.drain(tracker, step=K)
    _, x_sv, y_sv, alpha = stack[0]
    return CascadeResult(x_sv=x_sv, y_sv=y_sv, alpha=alpha,
                         levels_run=levels + 1)


# ---------------------------------------------------------------------------
# DiP-ODM / DC-ODM — SODM machinery with rival partition strategies
# ---------------------------------------------------------------------------

def _with_perm(spec: kf.KernelSpec, x: Tensor, y: Tensor, params: ODMParams,
               cfg: sodm_mod.SODMConfig, key, perm: Tensor,
               tracker=None) -> sodm_mod.SODMResult:
    """SODM on the data laid out by ``perm`` (identity inside), with the
    two permutations composed in the result."""
    res = sodm_mod._solve(
        spec, x[perm], y[perm], params,
        dataclasses.replace(cfg, partition_strategy="identity"), key,
        tracker=tracker)
    return res._replace(perm=perm[res.perm])


def _dip_solve(spec: kf.KernelSpec, x: Tensor, y: Tensor, params: ODMParams,
               cfg: sodm_mod.SODMConfig, key=None, *,
               perm: Tensor | None = None,
               tracker=None) -> sodm_mod.SODMResult:
    """DiP: the stratified deal with *k-means clusters as the strata*.

    As in the reference, the strata are read back from the sorted layout
    of :func:`partition.cluster_partitions` as equal slabs of M /
    n_landmarks positions, not as the cluster ids. ``perm`` injects the
    final layout (the parity seam); otherwise the generator draws the
    clustering, then the deal. ``tracker`` receives the level loop's
    per-level metrics."""
    if perm is None:
        gen = part_mod.as_generator(key)
        M = x.shape[0]
        K0 = cfg.p ** cfg.levels
        perm_c = part_mod.cluster_partitions(spec, x, cfg.n_landmarks, gen)
        stratum = torch.empty(M, dtype=torch.int64, device=x.device)
        stratum[perm_c] = torch.arange(M, device=x.device) \
            // (M // cfg.n_landmarks)
        perm = part_mod.stratified_partitions(stratum, K0, gen)
    return _with_perm(spec, x, y, params, cfg, key, perm, tracker)


def _dc_solve(spec: kf.KernelSpec, x: Tensor, y: Tensor, params: ODMParams,
              cfg: sodm_mod.SODMConfig, key=None, *,
              perm: Tensor | None = None,
              tracker=None) -> sodm_mod.SODMResult:
    """DC: the clusters are the partitions (``partition_strategy=
    "cluster"``). ``perm`` injects the layout (the parity seam);
    ``tracker`` as in :func:`_dip_solve`."""
    if perm is not None:
        return _with_perm(spec, x, y, params, cfg, key, perm, tracker)
    return sodm_mod._solve(
        spec, x, y, params,
        dataclasses.replace(cfg, partition_strategy="cluster"), key,
        tracker=tracker)


# ---------------------------------------------------------------------------
# gradient-based baselines (linear kernel)
# ---------------------------------------------------------------------------

class GradResult(NamedTuple):
    w: Tensor
    history: Tensor


def _svrg_epochs(x: Tensor, y: Tensor, params: ODMParams, epochs: int,
                 eta: float, key, batch: int, anchor_x: Tensor,
                 anchor_y: Tensor,
                 perms: Sequence[Tensor] | None) -> GradResult:
    """``epochs`` SVRG epochs: the anchor gradient h over (anchor_x,
    anchor_y) (one B7 launch on the card), then M // batch inner steps
    without replacement as one chain (one launch of the epoch kernel, B6's
    arithmetic step by step, every row weighted 1 and divided by the
    batch), then the objective."""
    M, d = x.shape
    steps = M // batch
    gen = part_mod.as_generator(key) if perms is None else None
    eta_t = torch.tensor(eta, dtype=x.dtype, device=x.device)
    # every step shares one all-ones mask and 1/batch (stride-0 step axes)
    wts = torch.ones(batch, dtype=x.dtype, device=x.device).expand(steps, -1)
    inv_n = torch.full((1, 1), 1.0 / batch, dtype=x.dtype,
                       device=x.device).expand(steps, -1)
    w = torch.zeros(d, dtype=x.dtype, device=x.device)
    hist = []
    for e in range(epochs):
        anchor = w
        h = ops.odm_grad(anchor, anchor_x, anchor_y, lam=params.lam,
                         theta=params.theta, ups=params.ups)
        order = (torch.randperm(M, generator=gen) if perms is None
                 else torch.as_tensor(perms[e]).to(torch.int64))
        idx = order[:steps * batch].to(x.device)
        xe = x[idx].reshape(1, steps, batch, d)
        ye = y[idx].reshape(1, steps, batch)
        w = og.odm_svrg_epoch(w, anchor, h, xe, ye, wts, inv_n, eta_t,
                              schedule="serial",
                              **dsvrg_mod._hinge_kw(params))
        hist.append(odm.primal_objective(w, x, y, params))
    history = torch.stack(hist) if hist else x.new_zeros(0)
    return GradResult(w=w, history=history)


def _svrg_solve(x: Tensor, y: Tensor, params: ODMParams, epochs: int,
                eta: float, key=None, batch: int = 1, *,
                _perms: Sequence[Tensor] | None = None) -> GradResult:
    """Plain single-machine SVRG (Johnson & Zhang 2013). ``_perms``
    injects each epoch's permutation of [M] (the parity seam); otherwise
    the generator draws them."""
    x, y = x.contiguous(), y.contiguous()
    return _svrg_epochs(x, y, params, epochs, eta, key, batch, x, y, _perms)


def kcenter_coreset(x: Tensor, n: int) -> Tensor:
    """Greedy k-center (farthest point) coreset indices: row 0 first, then
    the row farthest from the picks so far (the lowest index on ties, as
    ``jnp.argmax``). Reads no device value: each pick stays a device
    tensor."""
    M = x.shape[0]
    picks = torch.zeros(n, dtype=torch.int64, device=x.device)
    mind2 = torch.full((M,), torch.inf, dtype=x.dtype, device=x.device)
    i = torch.zeros(1, dtype=torch.int64, device=x.device)
    for s in range(n):
        if s > 0:
            i = torch.argmax(mind2).reshape(1)
        picks[s:s + 1] = i
        d2 = torch.sum((x - x.index_select(0, i)) ** 2, dim=1)
        mind2 = torch.minimum(mind2, d2)
    return picks


def _csvrg_solve(x: Tensor, y: Tensor, params: ODMParams, epochs: int,
                 eta: float, key=None, coreset_frac: float = 0.1,
                 batch: int = 1, *,
                 _perms: Sequence[Tensor] | None = None) -> GradResult:
    """Coreset SVRG (Tan et al. 2019): the anchor gradient over a k-center
    coreset of max(1, int(M · coreset_frac)) rows. ``_perms`` as in
    :func:`_svrg_solve`."""
    x, y = x.contiguous(), y.contiguous()
    n_core = max(1, int(x.shape[0] * coreset_frac))
    core = kcenter_coreset(x, n_core)
    return _svrg_epochs(x, y, params, epochs, eta, key, batch,
                        x[core].contiguous(), y[core].contiguous(), _perms)
