#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero):

1. Device and build: the card's name and power limit, the time nvcc took
   to build the kernels under src/repro_torch/kernels/csrc.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, timed with CUDA events beside its bound and a one-call
   PyTorch yardstick where one exists.
3. A whole Algorithm-1 fit of phishing (8.8k rows, d=68, rbf): levels 3
   and 2 take the dense pass (K1 + K3), levels 1 and 0 the matrix-free
   pass (K1 + K2); then the test set is scored (K2 as score_tiles).
4. The same at real size: ijcnn1 (113k training rows, d=22), all levels
   matrix-free. The launch counts are set to 0 just before each of the
   two fits and read just after its scoring: on phishing every kernel
   must have launched, on ijcnn1 K1, K2 and the scorer, and K3 not at all.
5. One small fit on the card against the same fit on the CPU (plain
   versions): alpha within 1e-4 and decision values within 1e-3 (the
   greedy argmax turns last-bit differences in the card's reductions into
   different coordinate orders over many passes).

The kernels line reports, per kernel: its time, its plain version's and
the yardstick's, the least time the card could take (bound_ms: the larger
of bytes moved over 3.35 TB/s and fp32 operations over 67 TFLOP/s, the
published H100 SXM peaks at 700 W; the text lines also give it scaled to
the card's printed power limit), and its launches: on the ijcnn1 path
for the kernels that path runs, on the phishing path for K3 (which runs
on phishing's dense levels only); ``launches_by_path`` gives both. The
last line is the result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def power_limit_w(card: str) -> float:
    """The power limit in watts from the nvidia-smi line ("..., 700.00 W")."""
    return float(card.rsplit(",", 1)[1].strip().split()[0])


def bound_text(b_ms: float, b_by: str, derate: float) -> str:
    """The bound at the published peaks, and scaled to the card's power
    limit (the peaks assume 700 W; a lower limit slows the card under
    load)."""
    return f"bound_ms={b_ms:.3f} ({b_by}; {b_ms * derate:.3f} at this limit)"


class LevelLog:
    """Tracker collecting the level loop's per-level metrics."""

    def __init__(self):
        self.rows = []

    def log_metrics(self, step, metrics):
        if "level" in metrics:
            self.rows.append(dict(metrics))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.api import ODMEstimator, ProblemSpec
        from repro_torch.core import kernel_fns as kf
        from repro_torch.core.odm import ODMParams
        from repro_torch.core.sodm import SODMConfig
        from repro_torch.data import synthetic
        from repro_torch.kernels import _build
        from repro_torch.kernels import dual_cd_block as cdk
        from repro_torch.kernels import gram as gram_mod
        from repro_torch.kernels import score as score_mod
    except ImportError as e:
        fail(f"cannot import the port from {ROOT}/src: {e}")
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           for m in sys.modules):
        fail("the port pulled in jax or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    derate = 700.0 / min(700.0, power_limit_w(card))
    say(f"card: {card}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    say(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path()})")
    log = _build.library_path().parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or line.startswith("=="):
                say("  " + line.strip())

    params = ODMParams(lam=100.0, theta=0.1, ups=0.5)
    cfg = SODMConfig(p=2, levels=3, n_landmarks=8, tol=1e-4,
                     max_sweeps=200, engine="pallas")
    phishing = synthetic.load("phishing")
    ijcnn1 = synthetic.load("ijcnn1")
    g_phish = kf.median_gamma(phishing.x_train)
    g_ijc = kf.median_gamma(ijcnn1.x_train)
    gen = torch.Generator(device="cpu").manual_seed(0)
    stats = {}

    # -- 2. kernels against their plain versions, main-path shapes ------------
    say("== phase 2: kernels vs plain versions on the card")
    # K2 at ijcnn1 level-3 shapes: K=8 partitions of m=M/8, padded to 256s
    M = ijcnn1.x_train.shape[0]
    K, m = 8, M // 8
    mp = -(-m // 256) * 256
    D = ijcnn1.x_train.shape[1]
    x3 = torch.zeros(K, mp, D)
    x3[:, :m] = ijcnn1.x_train[:K * m].reshape(K, m, D)
    y3 = torch.zeros(K, mp)
    y3[:, :m] = ijcnn1.y_train[:K * m].reshape(K, m)
    x3, y3 = x3.to(dev), y3.to(dev)
    g3 = (y3 * torch.randn(K, mp, generator=gen).to(dev)).contiguous()
    kw = dict(kind="rbf", gamma=g_ijc, degree=3, coef0=1.0)
    # the row norms are kept per level (KernelSource.xx), so the kernel is
    # timed without them
    xx3 = gram_mod.row_norms(x3)
    got = gram_mod.launch_gram_matvec(x3, x3, g3, xx=xx3, zz=xx3, **kw)
    want = gram_mod.gram_matvec_plain(x3, x3, g3, **kw)
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    say(f"K2 gram_matvec K={K} M=N={mp} D={D}: max_abs_err={err:.3e} "
        f"(max |u| {scale:.3e})")
    if not err <= 1e-5 * scale:
        fail("gram_matvec disagrees with its plain version")

    def yard_k2(x, z, g, gamma, rows=2048):
        out = []
        for r0 in range(0, x.shape[-2], rows):
            d2 = torch.cdist(x[..., r0:r0 + rows, :], z).square()
            out.append(torch.exp(-gamma * d2) @ g[..., :, None])
        return torch.cat(out, dim=-2)

    ms = time_ms(lambda: gram_mod.launch_gram_matvec(
        x3, x3, g3, xx=xx3, zz=xx3, **kw), 5)
    plain_ms = time_ms(lambda: gram_mod.gram_matvec_plain(x3, x3, g3, **kw),
                       2)
    lib_ms = time_ms(lambda: yard_k2(x3, x3, g3, g_ijc), 2)
    b_ms, b_by = bound(4 * (2 * K * mp * D + 4 * K * mp),
                       2 * K * mp * mp * (D + 1))
    stats["gram_matvec"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=b_ms,
                                bound_by=b_by)
    say(f"  ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        + bound_text(b_ms, b_by, derate))
    del x3, y3, g3, xx3, got, want

    # K1 on ijcnn1's level-0 diagonal blocks (cold start)
    mp0 = -(-M // 256) * 256
    T = mp0 // 256
    x0 = torch.zeros(mp0, D)
    x0[:M] = ijcnn1.x_train
    y0 = torch.zeros(mp0)
    y0[:M] = ijcnn1.y_train
    spec_ijc = kf.KernelSpec("rbf", g_ijc)
    qb = kf.signed_gram(spec_ijc, x0.reshape(T, 256, D).to(dev),
                        y0.reshape(T, 256).to(dev)).contiguous()
    a0 = torch.zeros(T, 512, device=dev)
    u0 = torch.zeros(T, 256, device=dev)
    v0 = (y0 != 0).to(torch.float32).reshape(T, 256).to(dev)
    ckw = dict(c=params.c, ups=params.ups, theta=params.theta,
               mscale=float(M), n_steps=512, exit_tol=0.01 * cfg.tol)
    a1, u1 = cdk.launch_cd_block_sweep(qb, a0, u0, v0, **ckw)
    a2, u2 = cdk._greedy_tile_sweep(qb, a0, u0, torch.cat([v0, v0], 1),
                                    **ckw)
    err = max(float((a1 - a2).abs().max()), float((u1 - u2).abs().max()))
    say(f"K1 cd_block_sweep tiles={T} B=256: max_abs_err={err:.3e}")
    if not err <= 1e-5:
        fail("cd_block_sweep disagrees with its plain version")
    ms = time_ms(lambda: cdk.launch_cd_block_sweep(qb, a0, u0, v0, **ckw), 5)
    plain_ms = time_ms(lambda: cdk._greedy_tile_sweep(
        qb, a0, u0, torch.cat([v0, v0], 1), **ckw), 1)
    # bytes: each input read once, each output written once; operations:
    # ~12 flops per coordinate per step at the step cap (bytes bound it
    # either way at these shapes)
    b_ms, b_by = bound(4 * (T * 256 * 256 + 2 * T * 512 + 3 * T * 256),
                       T * 512 * 12 * 512)
    stats["cd_block_sweep"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   library_ms=None, bound_ms=b_ms,
                                   bound_by=b_by)
    say(f"  ms={ms:.3f} plain_ms={plain_ms:.3f} "
        + bound_text(b_ms, b_by, derate))
    del qb, a0, u0, v0, a1, a2, u1, u2

    # K3 at phishing level-2 shapes: K=4 dense signed Q of m = M/4
    Mp = phishing.x_train.shape[0]
    K, m = 4, Mp // 4
    mp = -(-m // 256) * 256
    Dp = phishing.x_train.shape[1]
    xq = torch.zeros(K, mp, Dp)
    xq[:, :m] = phishing.x_train[:K * m].reshape(K, m, Dp)
    yq = torch.zeros(K, mp)
    yq[:, :m] = phishing.y_train[:K * m].reshape(K, m)
    Q = kf.signed_gram(kf.KernelSpec("rbf", g_phish), xq.to(dev),
                       yq.to(dev)).contiguous()
    dq = torch.randn(K, mp, generator=gen).to(dev)
    got = cdk.launch_dense_matvec(Q, dq)
    want = cdk.dense_matvec_plain(Q, dq)
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    say(f"K3 dense_matvec K={K} M=N={mp}: max_abs_err={err:.3e} "
        f"(max |u| {scale:.3e})")
    if not err <= 1e-5 * scale:
        fail("dense_matvec disagrees with its plain version")
    ms = time_ms(lambda: cdk.launch_dense_matvec(Q, dq), 20)
    plain_ms = time_ms(lambda: cdk.dense_matvec_plain(Q, dq), 20)
    lib_ms = time_ms(lambda: torch.bmm(Q, dq[:, :, None]), 20)
    b_ms, b_by = bound(4 * (K * mp * mp + 2 * K * mp), 2 * K * mp * mp)
    stats["dense_matvec"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=b_ms,
                                 bound_by=b_by)
    say(f"  ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        + bound_text(b_ms, b_by, derate))
    del Q, dq, got, want

    # -- 3 + 4. the main path: fit -> serve, phishing then ijcnn1 -------------
    counters = {"cd_block_sweep": cdk.cd_block_sweep,
                "gram_matvec": gram_mod.gram_matvec,
                "score_tiles": score_mod.score_tiles,
                "dense_matvec": cdk.dense_matvec}
    # the kernels each path must launch, and those it must not
    expect = {"phishing": (tuple(counters), ()),
              "ijcnn1": (("cd_block_sweep", "gram_matvec", "score_tiles"),
                         ("dense_matvec",))}
    fits, path_launches = {}, {}
    for phase, ds, gamma in ((3, phishing, g_phish), (4, ijcnn1, g_ijc)):
        say(f"== phase {phase}: fit {ds.name} M={ds.x_train.shape[0]} "
            f"d={ds.x_train.shape[1]} gamma={gamma:.4g}")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        est = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("rbf", gamma),
                                       params=params), cfg=cfg)
        levels = LevelLog()
        t0 = time.perf_counter()
        model, report = est.fit(ds.x_train, ds.y_train, 0, tracker=levels)
        fit_s = time.perf_counter() - t0
        for row in levels.rows:
            capped = row["sweeps"] >= cfg.max_sweeps
            say(f"  level {row['level']} K={row['K']} m={row['m']}: "
                f"passes={row['sweeps']} kkt={row['kkt']:.3e} "
                f"seconds={row['wall_s']:.3f}"
                + (" (hit max_sweeps)" if capped else ""))
            if not (row["kkt"] <= cfg.tol or capped):
                fail(f"{ds.name} level {row['level']} stopped at kkt "
                     f"{row['kkt']} > tol without reaching max_sweeps")
        t0 = time.perf_counter()
        f = est.decision_function(ds.x_test)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        if f.shape != (ds.x_test.shape[0],) or not bool(
                torch.isfinite(f).all()):
            fail(f"{ds.name} decision values malformed: {tuple(f.shape)}")
        acc = float((torch.sign(f).cpu() == ds.y_test).float().mean())
        major = float(max((ds.y_test > 0).float().mean(),
                          (ds.y_test < 0).float().mean()))
        say(f"  fit_s={fit_s:.2f} n_sv={report.n_sv} test_acc={acc:.4f} "
            f"(majority {major:.4f}) score_s={score_s:.4f} "
            f"(T={ds.x_test.shape[0]}) max_memory_allocated="
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        launches = {name: fn.launches for name, fn in counters.items()}
        say(f"  launches on the {ds.name} path: {launches}")
        ran, idle = expect[ds.name]
        for name in ran:
            if launches[name] <= 0:
                fail(f"kernel {name} never launched on the {ds.name} path")
        for name in idle:
            if launches[name] != 0:
                fail(f"kernel {name} launched on the {ds.name} path, "
                     f"which has no level that runs it")
        if not acc > 0.5:
            fail(f"{ds.name} test accuracy {acc} is no better than chance")
        fits[ds.name] = (model, f)
        path_launches[ds.name] = launches

    # K2 as score_tiles: ijcnn1's support vectors against its test set
    model, _ = fits["ijcnn1"]
    xt = ijcnn1.x_test.to(dev).contiguous()
    z, c = model.x_sv, model.coef
    skw = dict(kind="rbf", gamma=g_ijc, degree=3, coef0=1.0)
    got = gram_mod.launch_gram_matvec(xt[None], z[None], c[None], **skw)[0]
    want = score_mod.score_blocked(xt, z, c, **skw)
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    say(f"K2 score_tiles T={xt.shape[0]} S={z.shape[0]}: "
        f"max_abs_err={err:.3e} (max |f| {scale:.3e})")
    if not err <= 1e-5 * scale:
        fail("score_tiles disagrees with its plain version")
    ms = time_ms(lambda: gram_mod.launch_gram_matvec(
        xt[None], z[None], c[None], **skw), 5)
    plain_ms = time_ms(lambda: score_mod.score_blocked(xt, z, c, **skw), 2)
    lib_ms = time_ms(lambda: yard_k2(xt, z, c, g_ijc), 2)
    T, S = xt.shape[0], z.shape[0]
    b_ms, b_by = bound(4 * (T * D + S * D + 2 * S + 2 * T),
                       2 * T * S * (D + 1))
    stats["score_tiles"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=b_ms,
                                bound_by=b_by)
    say(f"  ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        + bound_text(b_ms, b_by, derate))

    # -- 5. the card against the CPU on one fit -------------------------------
    small = synthetic.load("phishing", scale=0.25)
    g_small = kf.median_gamma(small.x_train)
    cfg5 = SODMConfig(p=2, levels=3, n_landmarks=8, tol=1e-4,
                      max_sweeps=200, engine="pallas",
                      partition_strategy="identity")
    problem = ProblemSpec(kernel=kf.KernelSpec("rbf", g_small),
                          params=params)
    say(f"== phase 5: card vs CPU, phishing scale 0.25 "
        f"M={small.x_train.shape[0]}")
    out = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        est = ODMEstimator(problem, cfg=cfg5, device=where)
        _, rep = est.fit(small.x_train, small.y_train, 0)
        f = est.decision_function(small.x_test).cpu()
        out[where] = (rep.raw.alpha.cpu(), f, rep.passes)
        say(f"  {where}: passes={list(rep.passes)} kkt={rep.kkt:.3e} "
            f"seconds={time.perf_counter() - t0:.2f}")
    d_alpha = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    d_f = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    say(f"  max|alpha_card - alpha_cpu|={d_alpha:.3e} "
        f"max|f_card - f_cpu|={d_f:.3e}")
    if not (d_alpha <= 1e-4 and d_f <= 1e-3):
        fail("the card's fit disagrees with the CPU's")

    # -- report ----------------------------------------------------------------
    meta = {
        "cd_block_sweep": ("src/repro_torch/kernels/csrc/cd_sweep.cu",
                           "src/repro/kernels/dual_cd_block.py:120"),
        "gram_matvec": ("src/repro_torch/kernels/csrc/gram_matvec.cu",
                        "src/repro/kernels/gram.py:255"),
        "score_tiles": ("src/repro_torch/kernels/csrc/gram_matvec.cu",
                        "src/repro/kernels/score.py:84"),
        "dense_matvec": ("src/repro_torch/kernels/csrc/dense_matvec.cu",
                         "src/repro/kernels/dual_cd_block.py:264"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        s = stats[name]
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(s[key]):
                fail(f"{name}: {key} is not finite")
        path = "ijcnn1" if name in expect["ijcnn1"][0] else "phishing"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[path][name],
            "launches_path": path,
            "launches_by_path": {p: n[name] for p, n in
                                 path_launches.items()}, **s})
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
