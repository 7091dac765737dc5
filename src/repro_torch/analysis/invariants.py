"""Process-wide counters and the invariant registry: kernels, routes and
components DECLARE their invariants, one battery checks them.

Port of ``repro.analysis.invariants``. Two halves:

* the counter store (:class:`Counter`, :func:`counter`, :func:`counters`):
  every kernel wrapper holds its counter as ``<wrapper>.launches`` =
  ``counter("launch.<wrapper>")`` and bumps it where it launches its
  kernel; a captured CUDA graph bumps its kernel's counter on each replay;
  ``sodm`` counts its level solves in ``counter("sodm.level_solve")`` and
  ``sharding`` its collectives in ``counter("collective.<op>")``. Readers
  (``MetricsRegistry.snapshot(include_counters=True)``,
  ``chip_smoke.py``) go through :func:`counters`;
* the registry (:class:`Invariant`, :func:`declare`, :func:`invariants`,
  :func:`get`, :func:`verify`, :func:`verify_all`): every hand-written
  kernel (each :data:`~repro_torch.analysis.hopper_check.PLAN_BUILDERS`
  key), every registered route and every entry of :data:`COMPONENTS`
  declares its invariants as data, and ``tests/test_torch_invariants.py``
  runs one parametrised battery over :func:`invariants`; a coverage test
  asserts every kernel, route and component has a declaration.

Where the reference walks jaxprs and Pallas plans, the port records
dispatch plans (:mod:`~repro_torch.analysis.launch_lint`) and checks
launch plans (:mod:`~repro_torch.analysis.hopper_check`). Each
declaration's ``verify(device)`` runs on the CPU (the plain versions,
whose dispatch plan is the card's) or on ``"cuda"``, where every count
also holds its kernel sites against the ``launch.<name>`` counter deltas.

Import discipline: stdlib only at import time (the launch lint is too),
so every layer of the port can import this module for its counters; each
verify closure imports the subsystem it checks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.analysis import launch_lint as ll

__all__ = ["Counter", "counter", "counters", "Invariant", "declare",
           "invariants", "get", "verify", "verify_all", "COMPONENTS"]


class Counter:
    """A named process-wide event count."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def bump(self, n: int = 1) -> None:
        self.count += n

    def reset(self) -> None:
        self.count = 0

    def __repr__(self) -> str:
        return f"Counter({self.name!r}, count={self.count})"


_COUNTERS: dict[str, Counter] = {}


def counter(name: str) -> Counter:
    """Get-or-create the process-wide counter ``name``."""
    got = _COUNTERS.get(name)
    if got is None:
        got = _COUNTERS[name] = Counter(name)
    return got


def counters() -> dict[str, Counter]:
    return dict(_COUNTERS)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Invariant:
    """One declared plan-level invariant.

    ``subject`` is the kernel name (a ``hopper_check.PLAN_BUILDERS`` key),
    the route name (an ``api.registry`` route) or the component (a
    :data:`COMPONENTS` entry); ``kind`` says which namespace that is.
    ``verify(device)`` raises ``AssertionError`` (usually
    :class:`~repro_torch.analysis.launch_lint.InvariantViolation`) on
    failure; its return value is a human-readable result. ``slow`` marks
    declarations the quick tier skips (multi-process worlds)."""

    name: str
    subject: str
    kind: str                      # "kernel" | "route" | "component"
    description: str
    verify: Callable[[str], object] = dataclasses.field(compare=False)
    slow: bool = False

    def __post_init__(self):
        if self.kind not in ("kernel", "route", "component"):
            raise ValueError(f"kind must be 'kernel', 'route' or "
                             f"'component', got {self.kind!r}")


#: fault-tolerance / observability components under the coverage rule:
#: each carries >= 1 ``kind="component"`` declaration
COMPONENTS = ("checkpoint", "data", "faults", "resume", "tracker",
              "observe")

_REGISTRY: dict[str, Invariant] = {}


def declare(inv: Invariant) -> Invariant:
    """Register ``inv``; duplicate names raise (a pin silently replaced
    is a pin silently dropped)."""
    if inv.name in _REGISTRY:
        raise ValueError(f"invariant {inv.name!r} already declared")
    _REGISTRY[inv.name] = inv
    return inv


def invariants() -> tuple[Invariant, ...]:
    """All declared invariants, name-sorted (stable parametrize order)."""
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def get(name: str) -> Invariant:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no invariant {name!r}; declared: "
                       f"{sorted(_REGISTRY)}") from None


def verify(name: str, device: str = "cpu"):
    """Run one invariant by name on ``device``; raises on violation."""
    return get(name).verify(device)


def verify_all(include_slow: bool = False,
               device: str = "cpu") -> dict[str, object]:
    """Run every declared invariant on ``device``; returns {name: result}.
    Raises on the first violation (the battery in the tests runs them
    one by one)."""
    return {inv.name: inv.verify(device) for inv in invariants()
            if include_slow or not inv.slow}


# ---------------------------------------------------------------------------
# shared toy fixtures for the built-in declarations
# ---------------------------------------------------------------------------

def _toy_data(M: int = 32, d: int = 4, seed: int = 0, device: str = "cpu"):
    """Two shifted Gaussian blobs, shuffled: x (M, d), y (M,) ±1."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = torch.cat([torch.randn(M // 2, d, generator=g) + 1.0,
                   torch.randn(M // 2, d, generator=g) - 1.0])
    y = torch.cat([torch.ones(M // 2), -torch.ones(M // 2)])
    perm = torch.randperm(M, generator=g)
    return x[perm].to(device), y[perm].to(device)


def _sites(thunk, device: str):
    """Record ``thunk``'s dispatch plan; on the card also hold every
    wrapper's kernel sites against its ``launch.<name>`` counter delta.
    Returns (the thunk's result, the sites)."""
    launch = {n: c for n, c in counters().items() if n.startswith("launch.")}
    before = {n: c.count for n, c in launch.items()}
    out, sites = ll.run(thunk)
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
        for n, c in counters().items():
            if not n.startswith("launch."):
                continue
            delta = c.count - before.get(n, 0)
            seen = ll.count(sites, n[len("launch."):], device="cuda")
            if delta != seen:
                raise ll.InvariantViolation(
                    f"{n}: counter moved {delta}, the lint recorded {seen} "
                    f"kernel site(s)")
    return out, sites


def _kernel_sequence(sites) -> list[str]:
    return [s.name for s in sites if s.kind == ll.KERNEL]


def _expect_dispatches(thunk, want: list[str], what: str,
                       device: str) -> str:
    _, sites = _sites(thunk, device)
    got = _kernel_sequence(sites)
    if got != want:
        raise ll.InvariantViolation(
            f"{what}: expected the dispatch plan {want}, recorded {got}")
    return f"{what}: {len(want)} dispatch(es) {want}"


# ---------------------------------------------------------------------------
# kernel invariants
# ---------------------------------------------------------------------------

def _cd_sweep_single_launch(device: str):
    """One fused pass is two dispatches, K1 then K3 (dense Q) or K2
    (matrix-free): the Hopper counterpart of the reference's one-launch
    pass."""
    import torch
    from repro_torch.core import kernel_fns as kf
    from repro_torch.kernels import dual_cd_block as cdk
    from repro_torch.kernels import gram as gram_mod
    K, B, m, d = 2, 8, 16, 8
    x, y = _toy_data(K * m, d, device=device)
    xs, ys = x.reshape(K, m, d), y.reshape(K, m)
    spec = kf.KernelSpec(name="rbf", gamma=0.5)
    q = gram_mod.gram_plain(xs, xs, ys, ys, kind="rbf", gamma=0.5)
    qb = torch.stack([cdk.extract_diag_blocks(q[k], B) for k in range(K)])
    dense = gram_mod.DenseSource(q.contiguous())
    mfree = gram_mod.make_kernel_source(spec, xs, ys, bm=B)
    nblk = m // B
    a = torch.zeros(K, nblk, 2 * B, device=device)
    u = torch.zeros(K, nblk, B, device=device)
    v = torch.ones(K, nblk, B, device=device)
    kw = dict(c=1.0, ups=0.5, theta=0.1, mscale=float(m), n_steps=4,
              exit_tol=0.0)
    _expect_dispatches(lambda: cdk.fused_cd_pass(qb, dense, a, u, v, **kw),
                       ["cd_block_sweep", "dense_matvec"],
                       "fused_cd_pass[dense]", device)
    _expect_dispatches(lambda: cdk.fused_cd_pass(qb, mfree, a, u, v, **kw),
                       ["cd_block_sweep", "gram_matvec"],
                       "fused_cd_pass[matrix-free]", device)
    return "fused_cd_pass: 2 dispatches a pass (K1, then K3 or K2)"


def _gram_matvec_single_launch(device: str):
    import torch
    from repro_torch.kernels import gram as gram_mod
    x, _ = _toy_data(32, 8, device=device)
    xs = x.reshape(2, 16, 8)
    g = torch.ones(2, 16, device=device)
    return _expect_dispatches(
        lambda: gram_mod.gram_matvec(xs, xs, g, kind="rbf", gamma=0.5),
        ["gram_matvec"], "gram_matvec (all K partitions in one launch)",
        device)


def _dense_matvec_single_launch(device: str):
    import torch
    from repro_torch.kernels import dual_cd_block as cdk
    q = torch.eye(16, device=device).expand(2, 16, 16).contiguous()
    d = torch.ones(2, 16, device=device)
    return _expect_dispatches(lambda: cdk.dense_matvec(q, d),
                              ["dense_matvec"], "dense_matvec", device)


def _cd_exact_single_launch(device: str):
    from repro_torch.core import dual_cd
    from repro_torch.core.odm import ODMParams
    from repro_torch.kernels import gram as gram_mod
    x, y = _toy_data(32, 4, device=device)
    xs, ys = x.reshape(2, 16, 4), y.reshape(2, 16)
    q = gram_mod.gram_plain(xs, xs, ys, ys, kind="rbf", gamma=0.5)
    params = ODMParams(lam=1.0, theta=0.1, ups=0.5)
    return _expect_dispatches(
        lambda: dual_cd.solve(q, params, 16.0, tol=1e-4, max_sweeps=20),
        ["cd_exact"], "dual_cd.solve (every partition's chain in one "
        "launch)", device)


def _svrg_args(device: str, chains: int = 2, B: int = 8, d: int = 4):
    import torch
    x, y = _toy_data(chains * B, d, device=device)
    w = torch.zeros(chains, d, device=device)
    a = torch.zeros(d, device=device)
    h = torch.full((d,), 0.1, device=device)
    return (w, a, h, x.reshape(chains, B, d), y.reshape(chains, B),
            torch.ones(B, device=device),
            torch.full((1,), 1.0 / B, device=device))


def _svrg_grad_single_launch(device: str):
    from repro_torch.kernels import odm_grad as og
    w, a, h, x, y, wt, inv_n = _svrg_args(device)
    return _expect_dispatches(
        lambda: og.odm_svrg_grad(w, a, h, x, y, wt, inv_n, s=1.0),
        ["odm_svrg_grad"], "odm_svrg_grad (every chain in one launch)",
        device)


def _svrg_epoch_single_launch(device: str):
    import torch
    from repro_torch.kernels import odm_grad as og
    K, S, b, d = 2, 3, 4, 4
    x, y = _toy_data(K * S * b, d, device=device)
    xs, ys = x.reshape(K, S, b, d), y.reshape(K, S, b)
    wts = torch.ones(S, b, device=device)
    inv_n = torch.full((S, 1), 1.0 / b, device=device)
    eta = torch.full((1,), 0.1, device=device)
    w = torch.zeros(d, device=device)
    for schedule in ("serial", "parallel"):
        _expect_dispatches(
            lambda schedule=schedule: og.odm_svrg_epoch(
                w, w, w, xs, ys, wts, inv_n, eta, s=1.0,
                schedule=schedule),
            ["odm_svrg_epoch"], f"odm_svrg_epoch[{schedule}]", device)
    return "odm_svrg_epoch: one launch a whole epoch, both schedules"


def _b7_single_launch(device: str):
    import torch
    from repro_torch.kernels import odm_grad as og
    x, y = _toy_data(32, 8, device=device)
    w = torch.zeros(8, device=device)
    return _expect_dispatches(
        lambda: og.odm_grad(w, x, y), ["odm_grad"],
        "odm_grad (one dispatch: the row-ring pass and its column "
        "reduction)", device)


def _gram_single_launch(device: str):
    from repro_torch.kernels import gram as gram_mod
    x, y = _toy_data(32, 8, device=device)
    xs, ys = x.reshape(2, 16, 8), y.reshape(2, 16)
    return _expect_dispatches(
        lambda: gram_mod.gram(xs, yx=ys, kind="rbf", gamma=0.5), ["gram"],
        "gram (every partition's signed Gram in one launch)", device)


def _flash_single_launch(dtype: str):
    def run(device: str):
        import torch
        from repro_torch.kernels import flash_attn as fa
        g = torch.Generator().manual_seed(0)
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(1, 2, 16, 16, generator=g).to(device, dt)
                   for _ in range(3))
        return _expect_dispatches(lambda: fa.flash_attention(q, k, v),
                                  ["flash_attention"],
                                  f"flash_attention[{dtype}]", device)
    return run


def _flash_train_dispatches(kernel: str, dh: int = 16, kv: int = 2,
                            window: int | None = None):
    """The training attention: a forward is one dispatch (F), a backward
    two in order (N1-dq, whose D N1-dkdv reads, then N1-dkdv); each
    declaration holds its kernel's place in that plan (at head dim 256,
    recurrentgemma's, with its one kv head and a window: F's CUDA-core
    plan, N1's split plans and N1-dkdv's head-group sum)."""
    def run(device: str):
        import torch
        from repro_torch.models import attention as A
        g = torch.Generator().manual_seed(0)
        q = torch.randn(1, 24, 4, dh, generator=g).to(device)
        k, v = (torch.randn(1, 24, kv, dh, generator=g).to(device)
                for _ in range(2))
        q.requires_grad_()
        fwd = _expect_dispatches(
            lambda: A.attend(q, k, v, window=window, impl="flash_xla"),
            ["flash_attention_train"], "flash_xla forward", device)
        out = A.attend(q, k, v, window=window, impl="flash_xla")
        bwd = _expect_dispatches(
            lambda: torch.autograd.grad(out.sum(), q),
            ["flash_bwd_dq", "flash_bwd_dkdv"], "flash_xla backward",
            device)
        return f"{kernel}: {fwd}; {bwd}"
    return run


def _smem_plan(kernel: str):
    def run(device: str):
        from repro_torch.analysis import hopper_check as hc
        out = [hc.check_plan(p) for p in hc.default_plans().values()
               if p.kernel == kernel]
        if device == "cuda":
            plans = {k: p for k, p in hc.default_plans().items()
                     if p.kernel == kernel}
            for key, a in hc.check_device(plans).items():
                out.append(f"{key}: {a}")
        return "\n".join(out)
    return run


def _flash_f32_smem_ceiling(device: str):
    """B9 fp32's D = 128 tiles (128 query rows, 64 keys) at head dim 256
    (recurrentgemma's) need 397,312 B of shared memory a CTA: rejected at
    plan time with a sizing report, which is why D = 256 has its own plan
    (64 rows, 32 keys), which fits."""
    from repro_torch.analysis import hopper_check as hc
    hc.check_plan(hc.flash_f32_plan(D=256))
    rows, keys = hc.F32_TILES[128]
    try:
        hc.check_plan(hc.flash_f32_plan(D=256, bq=rows, bk=keys))
    except hc.HopperBudgetError as e:
        msg = str(e)
        assert "exceeds" in msg and "k_pt_ring" in msg, msg
        return ("flash_f32's D = 128 tiles at head dim 256 rejected at plan "
                "time (shared memory past 232,448 B); its D = 256 plan fits")
    raise ll.InvariantViolation(
        "the head-dim-256 fp32 flash plan at 128 rows and 64-key tiles fit "
        "the card: the ceiling is no longer caught; if the kernel's tiles "
        "changed, update flash_f32_plan")


# ---------------------------------------------------------------------------
# route invariants
# ---------------------------------------------------------------------------

_LINEAR_ROUTES = ("dsvrg", "svrg", "csvrg")


def _route_cfg(engine: str | None = None, epochs: int = 2):
    from repro_torch.core import dsvrg as dsvrg_mod
    from repro_torch.core import sodm as sodm_mod
    dcfg = dsvrg_mod.DSVRGConfig(n_partitions=4, epochs=epochs, batch=8,
                                 n_landmarks=4)
    return sodm_mod.SODMConfig(p=2, levels=2, n_landmarks=4, tol=1e-4,
                               max_sweeps=50, dsvrg=dcfg, engine=engine,
                               block=8)


def _estimator(route: str, device: str, **kw):
    from repro_torch.api import ODMEstimator, ProblemSpec
    kernel = "linear" if route in _LINEAR_ROUTES else "rbf"
    return ODMEstimator(ProblemSpec.create(kernel, gamma=0.5), route=route,
                        cfg=_route_cfg(**kw), device=device)


def _facade_artifact(route: str):
    """ODMEstimator.fit(route) on a toy problem returns a deployable
    FittedODM with no FutureWarning."""
    def run(device: str):
        import warnings

        from repro_torch.serve.model import FittedODM
        x, y = _toy_data(32, 4, device=device)
        est = _estimator(route, device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model, report = est.fit(x, y, 0)
        legacy = [w for w in caught if issubclass(w.category, FutureWarning)]
        if legacy:
            raise ll.InvariantViolation(
                f"route {route!r} fit raised FutureWarning(s): "
                f"{[str(w.message) for w in legacy]}")
        assert isinstance(model, FittedODM), type(model)
        assert report.route == route, report.route
        assert est.predict(x).shape == (32,)
        return f"route {route}: FittedODM artifact"
    return run


def _sodm_predict_gather_free(device: str):
    """The partition permutation is applied once, when the model is
    compiled: a served decision_function is one scorer dispatch with no
    gather and no host sync, call after call."""
    x, y = _toy_data(32, 4, device=device)
    model, _ = _estimator("sodm", device).fit(x, y, 0)
    rules = [ll.gather_free(), ll.no_host_sync_in(None),
             ll.max_launches("score_tiles", 1)]
    for rows in (slice(0, 8), slice(8, 24)):
        _, sites = _sites(lambda: model.decision_function(x[rows]), device)
        ll.check(sites, rules, subject="FittedODM.decision_function")
        if _kernel_sequence(sites) != ["score_tiles"]:
            raise ll.InvariantViolation(
                f"decision_function dispatched {_kernel_sequence(sites)}")
    return "sodm: decision_function is one gather-free, sync-free dispatch"


def _dsvrg_one_epoch_launch(device: str):
    """Every DSVRG epoch is one epoch-kernel dispatch and one B7 dispatch
    (the anchor gradient), with no host sync and no collective inside the
    epoch span: the host enqueues an epoch and never waits in it."""
    epochs = 3
    x, y = _toy_data(32, 4, device=device)
    est = _estimator("dsvrg", device, epochs=epochs)
    _, sites = _sites(lambda: est.fit(x, y, 0), device)
    ll.check(sites, [
        ll.expect_launches_per("dsvrg.epoch", "odm_svrg_epoch", 1),
        ll.expect_launches_per("dsvrg.epoch", "odm_grad", 1),
        ll.no_host_sync_in("dsvrg.epoch"),
        ll.no_collectives_in("dsvrg.epoch")], subject="dsvrg fit")
    n = len(ll.per_span(sites, "dsvrg.epoch", "odm_svrg_epoch"))
    if n != epochs:
        raise ll.InvariantViolation(f"{n} epoch spans for {epochs} epochs")
    return f"dsvrg: {epochs} epochs, each one epoch kernel + one B7, clean"


_HOIST_SCRIPT = r"""
import os
import sys
import torch
import torch.distributed as dist

from repro_torch import sharding as shd
from repro_torch.analysis.invariants import counter
from repro_torch.core import dsvrg
from repro_torch.core.odm import ODMParams

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
mesh = shd.make_mesh((2,), ("data",), "cpu")
params = ODMParams(lam=1.0, theta=0.1, ups=0.5)
g = torch.Generator().manual_seed(0)
x = torch.randn(32, 4, generator=g)
y = torch.sign(torch.randn(32, generator=g))


def all_gathers(epochs):
    cfg = dsvrg.DSVRGConfig(n_partitions=2, epochs=epochs, batch=8,
                            schedule="serial")
    c = counter("collective.all_gather")
    n0 = c.count
    dsvrg._solve_sharded(x, y, params, cfg, 0, mesh)
    return c.count - n0


a2, a6 = all_gathers(2), all_gathers(6)
# both ranks leave their last collective before either tears the group
# down, and the process ends without running gloo's thread teardown at
# interpreter exit (which can abort after the result is printed)
dist.barrier()
dist.destroy_process_group()
print(f"{a2} {a6}", flush=True)
os._exit(0)
"""


def _dsvrg_sharded_gather_hoisted(device: str):
    """The sharded serial schedule all-gathers its (loop-invariant) slab
    ONCE a solve, outside the epoch loop: on a 2-rank gloo world the
    ``collective.all_gather`` count does not grow with the epochs."""
    import os
    import subprocess
    import sys
    import tempfile
    src_root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                            ".."))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _HOIST_SCRIPT, str(r), store], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise ll.InvariantViolation(
                f"sharded gather-hoist check failed:\n{out}\n{err}")
    counts = [tuple(int(v) for v in out.split()) for out, _ in outs]
    for a2, a6 in counts:
        if a2 <= 0:
            raise ll.InvariantViolation(
                "no all_gather at all: the serial schedule changed?")
        if a2 != a6:
            raise ll.InvariantViolation(
                f"all_gather count grows with the epochs ({a2} at 2 vs {a6} "
                f"at 6): the slab gather slid inside the epoch loop")
    return f"all_gathers={counts[0][0]} at 2 and 6 epochs, on both ranks"


# ---------------------------------------------------------------------------
# component invariants (fault tolerance + observability)
# ---------------------------------------------------------------------------

def _faults_deterministic_replay(device: str):
    """The same FaultPlan against the same loop fires at the same site
    every time; kills raise Preemption, delays return (and with
    sleeper=None never sleep) their seconds, every rule is spent after
    its count."""
    from repro_torch.distributed import faults as fm

    def drive(plan):
        visited = []
        try:
            for lvl in (3, 2, 1, 0):
                plan.site("cascade.level", level=lvl, K=2 ** lvl)
                visited.append(lvl)
        except fm.Preemption as e:
            visited.append(("kill", e.info["level"]))
        return visited

    a = drive(fm.FaultPlan().kill_at_level(1))
    b = drive(fm.FaultPlan().kill_at_level(1))
    if not (a == b == [3, 2, ("kill", 1)]):
        raise ll.InvariantViolation(
            f"fault replay is not deterministic: {a} vs {b}")
    plan = fm.FaultPlan(sleeper=None).delay_partition(2, 0.5)
    got = (plan.site("cascade.partition", partition=1),
           plan.site("cascade.partition", partition=2),
           plan.site("cascade.partition", partition=2))
    if got != (0.0, 0.5, 0.0):
        raise ll.InvariantViolation(
            f"delay rule mis-fired or was not spent: {got}")
    if plan.fired != [("delay", "cascade.partition", {"partition": 2})]:
        raise ll.InvariantViolation(f"fired log wrong: {plan.fired}")
    return "faults: deterministic replay, counts spend, virtual delays"


def _checkpoint_crash_window(device: str):
    """A kill between the fsync'd temp write and the atomic rename never
    disturbs the committed step, and the orphan is collected by the next
    save."""
    import os
    import tempfile

    import torch

    from repro_torch.distributed import checkpoint as ck
    from repro_torch.distributed import faults as fm

    a = torch.arange(4.0, device=device)
    with tempfile.TemporaryDirectory() as d:
        plan = fm.FaultPlan()
        mgr = ck.CheckpointManager(d, keep=3, faults=plan)
        mgr.save(1, {"a": a})
        plan.kill_mid_checkpoint()   # armed AFTER step 1 committed
        try:
            mgr.save(2, {"a": a + 1.0})
        except fm.Preemption:
            pass
        else:
            raise ll.InvariantViolation("kill_mid_checkpoint did not fire")
        if mgr.latest_step() != 1:
            raise ll.InvariantViolation(
                f"crash window corrupted the committed step: "
                f"latest={mgr.latest_step()}")
        back = mgr.restore({"a": torch.zeros(4)})
        assert torch.equal(back["a"], a.cpu())
        if not [n for n in os.listdir(d) if ".tmp." in n]:
            raise ll.InvariantViolation(
                "the killed writer left no orphan: the site is not in the "
                "crash window")
        mgr.save(2, {"a": a + 1.0})
        left = [n for n in os.listdir(d) if ".tmp." in n]
        if left:
            raise ll.InvariantViolation(f"orphans survived the gc: {left}")
    return "checkpoint: crash window safe, orphan collected on next save"


def _resume_cascade_bit_identical(device: str):
    """Kill the fit mid-cascade; fit(resume=) returns a bit-identical
    result with fewer level solves than a cold restart."""
    import tempfile

    import torch

    from repro_torch.core import sodm
    from repro_torch.distributed import faults as fm

    x, y = _toy_data(32, 4, device=device)
    _, base = _estimator("sodm", device).fit(x, y, 0)
    levels = _route_cfg().levels
    with tempfile.TemporaryDirectory() as d:
        try:
            _estimator("sodm", device).fit(
                x, y, 0, resume=d, faults=fm.FaultPlan().kill_at_level(1))
        except fm.Preemption:
            pass
        else:
            raise ll.InvariantViolation("kill_at_level(1) did not fire")
        c0 = sodm.level_solve_count()
        _, resumed = _estimator("sodm", device).fit(x, y, 0, resume=d)
        ran = sodm.level_solve_count() - c0
    cold = levels + 1
    if ran >= cold:
        raise ll.InvariantViolation(
            f"resume re-ran {ran} level solves, not fewer than the cold "
            f"restart's {cold}")
    if not torch.equal(resumed.raw.alpha, base.raw.alpha):
        raise ll.InvariantViolation("resumed duals differ bitwise")
    return f"resume(cascade): bit-identical, {ran} < {cold} level solves"


def _resume_dsvrg_segments(device: str):
    """The dsvrg route checkpoints (w, epoch) between segments; a killed
    and resumed solve equals the uninterrupted segmented run bit for
    bit."""
    import tempfile

    import torch

    from repro_torch.distributed import faults as fm

    x, y = _toy_data(32, 4, device=device)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        model_a, _ = _estimator("dsvrg", device, epochs=4).fit(
            x, y, 0, resume=d1)
        try:
            _estimator("dsvrg", device, epochs=4).fit(
                x, y, 0, resume=d2, faults=fm.FaultPlan().kill_at_epoch(2))
        except fm.Preemption:
            pass
        else:
            raise ll.InvariantViolation("kill_at_epoch(2) did not fire")
        model_b, _ = _estimator("dsvrg", device, epochs=4).fit(
            x, y, 0, resume=d2)
    if not torch.equal(model_a.w, model_b.w):
        raise ll.InvariantViolation(
            "resumed dsvrg iterate differs bitwise from the uninterrupted "
            "segmented run")
    return "resume(dsvrg): killed+resumed w bitwise == uninterrupted"


def _tracker_level_stream(device: str):
    """The tracker receives one record per cascade level (KKT, sweeps,
    SV count, throughput) and a final fit summary; the jsonl backend
    round-trips the stream and skips a torn tail line."""
    import os
    import tempfile

    from repro_torch import observe

    x, y = _toy_data(32, 4, device=device)
    levels = _route_cfg().levels
    mem = observe.InMemoryTracker()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "metrics.jsonl")
        with observe.JsonlTracker(path) as jt:
            _estimator("sodm", device).fit(
                x, y, 0, tracker=observe.CompositeTracker([mem, jt]))
        with open(path, "a") as f:
            f.write('{"step": 99, "torn')       # killed mid-line
        records = observe.read_jsonl(path)
    lvls = [m for _, m in mem.steps if "level" in m]
    if len(lvls) != levels + 1:
        raise ll.InvariantViolation(
            f"expected {levels + 1} per-level records, got {len(lvls)}")
    missing = {"level", "kkt", "sweeps", "sv_count", "rows_per_s"} \
        - set(lvls[0])
    if missing:
        raise ll.InvariantViolation(f"level record missing {missing}")
    if not mem.latest().get("fit_done"):
        raise ll.InvariantViolation("no final fit summary was logged")
    if len(records) != len(mem.steps):
        raise ll.InvariantViolation(
            f"jsonl round trip lost records ({len(records)} vs "
            f"{len(mem.steps)}) or kept the torn line")
    return "tracker: per-level stream + summary, torn-tail-safe jsonl"


def _plan(sites) -> list[tuple]:
    return [(s.name, s.device, s.shapes) for s in sites
            if s.kind == ll.KERNEL]


def _observe_zero_cost_off(device: str):
    """Spans, the tracker and the profiler are free when off and inert
    when on: (a) with no recorder ``span()`` returns the shared no-op;
    (b) a fit under ``trace_dir``, ``profile_dir`` and a tracker equals
    the bare fit bit for bit and dispatch for dispatch, on sodm (its
    trace nests cascade.level inside fit, its profile is valid Chrome
    JSON) and on dsvrg."""
    import json
    import os
    import tempfile

    import torch

    from repro_torch import observe
    from repro_torch.observe import spans as spans_mod

    if spans_mod.current_recorder() is not None:
        raise ll.InvariantViolation(
            "a span recorder leaked in from a previous test")
    if observe.span("a", k=1) is not observe.span("b"):
        raise ll.InvariantViolation(
            "span() with no recorder must return the shared no-op")
    x, y = _toy_data(32, 4, device=device)
    for route in ("sodm", "dsvrg"):
        kw = {"engine": "pallas"} if route == "sodm" else {}
        (bare, _), bare_sites = _sites(
            lambda: _estimator(route, device, **kw).fit(x, y, 0), device)
        with tempfile.TemporaryDirectory() as d:
            (inst, _), inst_sites = _sites(
                lambda: _estimator(route, device, **kw).fit(
                    x, y, 0, tracker=observe.MetricsRegistry(),
                    trace_dir=os.path.join(d, "t"),
                    profile_dir=os.path.join(d, "p")), device)
            with open(os.path.join(d, "t", "trace.json")) as f:
                trace = json.load(f)
            with open(os.path.join(d, "p", observe.profiler.FILENAME)) as f:
                if not json.load(f)["traceEvents"]:
                    raise ll.InvariantViolation("empty profiler trace")
        if _plan(bare_sites) != _plan(inst_sites):
            raise ll.InvariantViolation(
                f"{route}: instrumentation changed the dispatch plan "
                f"({len(_plan(bare_sites))} vs {len(_plan(inst_sites))} "
                f"kernel dispatches)")
        a = bare.w if bare.w is not None else bare.coef
        b = inst.w if inst.w is not None else inst.coef
        if not torch.equal(a, b):
            raise ll.InvariantViolation(
                f"{route}: the instrumented fit differs bitwise from the "
                f"bare fit")
        if route == "sodm":
            events = trace["traceEvents"]
            fits = [e for e in events if e["name"] == "fit"]
            lvls = [e for e in events if e["name"] == "cascade.level"]
            if len(fits) != 1 or not lvls:
                raise ll.InvariantViolation(
                    f"expected 1 fit span and >= 1 cascade.level spans, got "
                    f"{len(fits)}/{len(lvls)}")
            f0 = fits[0]
            for e in lvls:
                if not (f0["ts"] <= e["ts"] and e["ts"] + e["dur"]
                        <= f0["ts"] + f0["dur"]):
                    raise ll.InvariantViolation(
                        "cascade.level span not contained in the fit span")
    return ("observe: off path is the shared no-op; traced + profiled + "
            "tracked fits equal the bare fits bitwise, dispatch for "
            "dispatch (sodm, dsvrg)")


def _data_stream_loader(device: str):
    """The out-of-core data plane: (a) slab contents do not depend on how
    the source is sharded; (b) one pass reads every shard once and the
    rows counter / depth gauge are honest; (c) the byte accountant's peak
    stays below the dataset; (d) a kill at ``data.prefetch`` surfaces
    from the iteration as Preemption."""
    import numpy as np

    from repro_torch.data import streaming as ds
    from repro_torch.distributed import faults as fm
    from repro_torch.observe import MetricsRegistry

    rng = np.random.default_rng(0)
    M, d, slab = 96, 5, 32
    x = rng.normal(size=(M, d)).astype(np.float32)
    y = np.where(rng.random(M) < 0.5, -1.0, 1.0).astype(np.float32)

    def slabs(shard_rows):
        src = ds.ArraySource(x, y, shard_rows=shard_rows)
        acct = ds.ByteAccountant()
        mets = MetricsRegistry()
        out = [(np.asarray(s.x).copy(), np.asarray(s.y).copy(), s.n_valid)
               for s in ds.iter_slabs(src, slab, depth=2, metrics=mets,
                                      executor=ds.SerialExecutor(),
                                      accountant=acct)]
        return src, acct, mets, out

    src_a, acct, mets, a = slabs(16)
    _, _, _, b = slabs(24)          # misaligned: shards straddle slabs
    for (xa, ya, na), (xb, yb, nb) in zip(a, b, strict=True):
        if not (np.array_equal(xa, xb) and np.array_equal(ya, yb)
                and na == nb):
            raise ll.InvariantViolation(
                "slab contents depend on the shard layout")
    if src_a.reads != [1] * len(src_a.reads):
        raise ll.InvariantViolation(
            f"one pass must read each shard exactly once: {src_a.reads}")
    snap = mets.snapshot()
    if snap.get("data.rows.count") != M:
        raise ll.InvariantViolation(
            f"rows counter lies: {snap.get('data.rows.count')} != {M}")
    if snap.get("data.prefetch.depth.max", 0) > 2:
        raise ll.InvariantViolation(
            f"prefetch queue exceeded its depth bound: "
            f"{snap['data.prefetch.depth.max']} > 2")
    if snap.get("data.shard.read_s.count") != len(src_a.reads):
        raise ll.InvariantViolation(
            f"shard-read histogram count "
            f"{snap.get('data.shard.read_s.count')} != shard count")
    if not 0 < acct.peak < src_a.total_bytes:
        raise ll.InvariantViolation(
            f"accountant peak {acct.peak} not inside (0, "
            f"{src_a.total_bytes}): the loader materialized the set")
    plan = fm.FaultPlan().kill("data.prefetch", shard=2)
    try:
        for _ in ds.iter_slabs(ds.ArraySource(x, y, shard_rows=16), slab,
                               faults=plan, executor=ds.SerialExecutor()):
            pass
    except fm.Preemption as e:
        if e.info.get("shard") != 2:
            raise ll.InvariantViolation(f"kill struck shard {e.info}")
    else:
        raise ll.InvariantViolation(
            "a data.prefetch kill never surfaced from the iteration")
    return ("data: slabs layout-invariant, single-read passes, honest "
            "gauges, bounded resident bytes, kills propagate")


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------

def _declare_builtins() -> None:
    single = {
        "cd_sweep": ("a fused pass is two dispatches: K1, then K3 or K2",
                     _cd_sweep_single_launch),
        "gram_matvec": ("one dispatch for all K partition matvecs",
                        _gram_matvec_single_launch),
        "dense_matvec": ("one dispatch for all K partitions",
                         _dense_matvec_single_launch),
        "cd_exact": ("one dispatch solves every partition",
                     _cd_exact_single_launch),
        "svrg_grad": ("one dispatch for every chain's inner step",
                      _svrg_grad_single_launch),
        "svrg_epoch": ("one dispatch a whole epoch, both schedules",
                       _svrg_epoch_single_launch),
        "b7_ring": ("one dispatch a full-batch gradient",
                    _b7_single_launch),
        "gram": ("one dispatch for every partition's Gram",
                 _gram_single_launch),
        "flash_bf16": ("one dispatch an attention call",
                       _flash_single_launch("bfloat16")),
        "flash_f32": ("one dispatch an attention call",
                      _flash_single_launch("float32")),
        "flash_f32_stats": ("one dispatch a training attention forward "
                            "(F's split kernel, then flash_f32_stats)",
                            _flash_train_dispatches("flash_f32_stats")),
        "flash_fwd_split": ("one dispatch a training attention forward "
                            "(flash_fwd_split, then F's flash_f32_stats)",
                            _flash_train_dispatches("flash_fwd_split")),
        "flash_bwd_dq": ("a training attention backward is N1-dq, then "
                         "N1-dkdv", _flash_train_dispatches("flash_bwd_dq")),
        "flash_bwd_dkdv": ("a training attention backward is N1-dq, then "
                           "N1-dkdv",
                           _flash_train_dispatches("flash_bwd_dkdv")),
        "flash_bwd_dkdv_sum": ("at head dim 256 (four query heads a kv "
                               "head) a training attention backward is "
                               "still N1-dq, then N1-dkdv: the head "
                               "groups' sum runs inside N1-dkdv's call",
                               _flash_train_dispatches(
                                   "flash_bwd_dkdv_sum", dh=256, kv=1,
                                   window=8)),
    }
    for kernel, (desc, fn) in single.items():
        declare(Invariant(name=f"kernels.{kernel}.single_launch",
                          subject=kernel, kind="kernel", description=desc,
                          verify=fn))
        declare(Invariant(
            name=f"kernels.{kernel}.smem_plan", subject=kernel,
            kind="kernel",
            description="the main path's launch plans fit the H100 (on the "
                        "card: the built kernel matches its plan, no "
                        "spill)", verify=_smem_plan(kernel)))
    declare(Invariant(
        name="kernels.flash_f32_stats.d256_dispatches",
        subject="flash_f32_stats", kind="kernel",
        description="at head dim 256 (GQA 4:1, a window) a training "
                    "attention forward is one F dispatch and its backward "
                    "N1-dq, then N1-dkdv",
        verify=_flash_train_dispatches("flash_f32_stats", dh=256, kv=1,
                                       window=8)))
    declare(Invariant(
        name="kernels.flash_f32.smem_ceiling", subject="flash_f32",
        kind="kernel",
        description="the D = 128 tiles at head dim 256 are REJECTED at plan "
                    "time with a sizing report", verify=_flash_f32_smem_ceiling))

    for route in ("sodm", "dsvrg", "cascade", "dip", "dc", "svrg",
                  "csvrg"):
        declare(Invariant(
            name=f"routes.{route}.facade_artifact", subject=route,
            kind="route",
            description="ODMEstimator.fit returns a FittedODM with no "
                        "FutureWarning", verify=_facade_artifact(route)))
    declare(Invariant(
        name="routes.sodm.predict_gather_once", subject="sodm",
        kind="route",
        description="decision_function is one scorer dispatch, gather-free "
                    "and sync-free", verify=_sodm_predict_gather_free))
    declare(Invariant(
        name="routes.dsvrg.one_epoch_launch", subject="dsvrg", kind="route",
        description="one epoch-kernel and one B7 dispatch an epoch span, "
                    "no host sync and no collective inside it",
        verify=_dsvrg_one_epoch_launch))
    declare(Invariant(
        name="routes.dsvrg.sharded_gather_hoisted", subject="dsvrg",
        kind="route", slow=True,
        description="on a 2-rank gloo world the serial schedule's "
                    "all_gather count does not grow with the epochs",
        verify=_dsvrg_sharded_gather_hoisted))

    comp = [
        ("components.faults.deterministic_replay", "faults",
         "fault plans replay deterministically; kills raise, delays "
         "return seconds, counts spend", _faults_deterministic_replay),
        ("components.checkpoint.crash_window", "checkpoint",
         "a kill in the write/rename window keeps the previous step "
         "loadable and the orphan is collected on the next save",
         _checkpoint_crash_window),
        ("components.resume.cascade_bit_identical", "resume",
         "kill-mid-cascade + fit(resume=) is bit-identical with fewer "
         "level solves than a cold restart",
         _resume_cascade_bit_identical),
        ("components.resume.dsvrg_segments", "resume",
         "dsvrg segment checkpoints make killed+resumed bitwise equal "
         "to the uninterrupted segmented run", _resume_dsvrg_segments),
        ("components.tracker.level_stream", "tracker",
         "per-level KKT/sweeps/SV/throughput records + fit summary; "
         "jsonl backend is torn-tail-safe", _tracker_level_stream),
        ("components.observe.zero_cost_off", "observe",
         "spans/tracker/profiler are no-ops when off; a traced, profiled "
         "and tracked fit equals the bare fit bitwise, dispatch for "
         "dispatch", _observe_zero_cost_off),
        ("components.data.stream_loader", "data",
         "slabs are bitwise layout-invariant; one read per shard per "
         "pass; depth/rows instruments honest; resident bytes bounded "
         "below the dataset; prefetch kills propagate",
         _data_stream_loader),
    ]
    for name, subject, desc, fn in comp:
        declare(Invariant(name=name, subject=subject, kind="component",
                          description=desc, verify=fn))


_declare_builtins()
