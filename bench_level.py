#!/usr/bin/env python3
"""Time K1 (greedy tile sweep), K2 (Gram matvec), K4 (the exact dual CD
solve) and B7 (the DSVRG anchor gradient) at their main paths' shapes on
one card.

  PYTHONPATH=src python3 bench_level.py [--rounds 3] [--seed 0]

Shapes (data from ``repro_torch.data.synthetic``, as chip_smoke.py makes
them; rbf at the median gamma):

* K2 at ijcnn1's level 3 (K=8, M=N=14,336, D=22), level 0 (K=1,
  M=N=113,408, D=22) and phishing's level 1 (K=2, M=N=4,608, D=68), with
  the row norms given as a level keeps them; and as the scorer at
  ijcnn1's test set against 93,675 rows (T=28,344, S=93,675, D=22).
* K1 cold at ijcnn1's level 0 (443 tiles of B=256, 512 steps, exit at
  1e-6, lam=100) and phishing's level 3 (40 tiles), handed the tiles as
  the level solve hands them (transposed once, where the checkout's K1
  reads the transpose).
* The host's cost of one level pass (``fused_cd_pass``: K1, the step's
  difference, K2 through a ``KernelSource``) at phishing's level 1,
  and of one K2 call at that shape: the card is held by a sleep kernel
  while the calls are queued, so the host's clock reads the Python and
  launch work alone.
* K4 at the cascade's level 3 on phishing (K=8 partitions of m=1,104,
  cold, tol 1e-4, the 100-sweep cap) and at a merged node (K=1, m=2,208,
  warm from partitions 0 and 1 of level 3), as chip_smoke.py phase 2c
  runs them.
* B7 at SUSY's 4,000,000 x 18 and at 4,800 x 5,000 (gisette's width),
  device time with the card held while the calls are queued.
* The cascade's fit on phishing (chip_smoke.py phase 8: CFG_CASCADE,
  levels=3, max_sweeps=100, lam=100), end to end through
  ``ODMEstimator``: the least fit time of three after a warm-up fit, its
  test accuracy and the sum of its decision values (to compare two
  checkouts' results).

It prints one JSON line: the card's name and power limit, the build's
hash, and per shape the median over ``--rounds`` of the mean ms per call
by CUDA events (for the host costs, the least of five rounds of host µs
per call), with K2's largest error against its plain version at the
level-3 shape and K1's at the level-0 shape. It uses only the wrappers and their launchers, so the same
file times another checkout's kernels with ``PYTHONPATH=<checkout>/src``;
alternate two checkouts in one run on one card to compare them.
chip_smoke.py lays out its phase-2 partitions and K1 tiles with
:func:`partitions` and :func:`k1_tiles`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from repro_torch.core import dual_cd
from repro_torch.core import kernel_fns as kf
from repro_torch.core.odm import ODMParams
from repro_torch.data import synthetic
from repro_torch.kernels import _build
from repro_torch.kernels import dual_cd_block as cdk
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels import odm_grad as og


def _ms(fn, reps: int, hold: bool = False) -> float:
    """Mean ms per call by CUDA events after one warm-up; with ``hold``
    a sleep kernel holds the card while the calls are queued, so the
    host's launch cost is left out (for calls shorter than it)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(int(2e8))  # about 0.1 s at the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, reps: int) -> float:
    """Host microseconds per call of ``fn``, queued while a sleep kernel
    holds the card (so no call waits on the device)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # about a second at the card's clock
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e6


def partitions(x, y, K: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The first K * m rows as K partitions of m = M // K, zero-padded to a
    multiple of 256 rows (labels 0 on padding), as a level lays them out."""
    M, D = x.shape
    m = M // K
    mp = -(-m // 256) * 256
    xs = torch.zeros(K, mp, D)
    xs[:, :m] = x[:K * m].reshape(K, m, D)
    ys = torch.zeros(K, mp)
    ys[:, :m] = y[:K * m].reshape(K, m)
    return xs.to(dev), ys.to(dev)


def k1_tiles(x, y, K: int, gamma: float, dev):
    """A level's diagonal tiles (K * nblk of 256, rbf at gamma, signed),
    contiguous, and their valid masks (T, 256)."""
    xs, ys = partitions(x, y, K, dev)
    T = K * xs.shape[1] // 256
    qb = kf.signed_gram(kf.KernelSpec("rbf", gamma),
                        xs.reshape(T, 256, -1), ys.reshape(T, 256))
    return qb.contiguous(), (ys != 0).float().reshape(T, 256)


def level_tiles(qb: torch.Tensor) -> torch.Tensor:
    """The tiles as the level solve hands them to K1: a view over their
    transposed copy. Only for comparisons with a checkout from before K1
    read the transpose (it has no ``transpose_tiles``): there, the tiles
    themselves."""
    if not hasattr(cdk, "transpose_tiles"):
        return qb
    return cdk.transpose_tiles(qb).transpose(-1, -2)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="k2,k1,host,k4,b7,cascade",
                    help="comma-separated groups to time (default: all)")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("bench_level needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    ijc, phi = synthetic.load("ijcnn1"), synthetic.load("phishing")
    g_ijc = kf.median_gamma(ijc.x_train)
    g_phi = kf.median_gamma(phi.x_train)
    res: dict = {}

    def k2(name, x, z, g, gamma, reps, xx=None, zz=None, check=False):
        kw = dict(kind="rbf", gamma=gamma, degree=3, coef0=1.0)
        call = lambda: gram_mod.launch_gram_matvec(x, z, g, xx=xx, zz=zz,
                                                   **kw)
        if check:
            err = float((call() - gram_mod.gram_matvec_plain(x, z, g, **kw))
                        .abs().max())
            res[name + "_max_abs_err"] = err
        res[name + "_ms"] = statistics.median(
            _ms(call, reps) for _ in range(args.rounds))

    for name, ds, K, gamma, reps, check in () if "k2" not in only else (
            ("k2_ijcnn1_l3", ijc, 8, g_ijc, 10, True),
            ("k2_ijcnn1_l0", ijc, 1, g_ijc, 3, False),
            ("k2_phishing_l1", phi, 2, g_phi, 20, False)):
        xs, ys = partitions(ds.x_train, ds.y_train, K, dev)
        g = (ys * torch.randn(ys.shape, generator=gen).to(dev)).contiguous()
        xx = gram_mod.row_norms(xs)
        k2(name, xs, xs, g, gamma, reps, xx=xx, zz=xx, check=check)
        del xs, ys, g, xx
    if "k2" in only:
        xt = ijc.x_test.to(dev).contiguous()[None]
        sv = ijc.x_train[:93675].to(dev).contiguous()[None]
        coef = torch.randn(1, 93675, generator=gen).to(dev)
        k2("k2_score", xt, sv, coef, g_ijc, 5)
        del xt, sv, coef

    p = ODMParams(lam=100.0, theta=0.1, ups=0.5)  # chip_smoke's setting
    ckw = dict(c=p.c, ups=p.ups, theta=p.theta, n_steps=512, exit_tol=1e-6)
    for name, ds, K, gamma, reps, check in () if "k1" not in only else (
            ("k1_ijcnn1_l0", ijc, 1, g_ijc, 5, True),
            ("k1_phishing_l3", phi, 8, g_phi, 20, False)):
        qb, v = k1_tiles(ds.x_train, ds.y_train, K, gamma, dev)
        T = qb.shape[0]
        a0 = torch.zeros(T, 512, device=dev)
        u0 = torch.zeros(T, 256, device=dev)
        kw = dict(ckw, mscale=float(ds.x_train.shape[0] // K))
        q_in = level_tiles(qb)
        call = lambda: cdk.launch_cd_block_sweep(q_in, a0, u0, v, **kw)
        if check:
            a1, u1 = call()
            a2, u2 = cdk._greedy_tile_sweep(qb, a0, u0, torch.cat([v, v], 1),
                                            **kw)
            res[name + "_max_abs_err"] = max(
                float((a1 - a2).abs().max()), float((u1 - u2).abs().max()))
        res[name + "_ms"] = statistics.median(
            _ms(call, reps) for _ in range(args.rounds))
        res[name + "_tiles"] = T
        del qb, v, q_in, a0, u0

    if "host" in only:
        host_costs(res, phi, g_phi, ckw, gen, dev)
    if "k4" in only:
        k4_times(res, phi, g_phi, args.rounds, dev)
    if "b7" in only:
        b7_times(res, gen, args.rounds, dev)
    if "cascade" in only:
        cascade_fit(res, phi, g_phi)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    out = {"card": card, "build": _build.library_path().parent.name, **res}
    print(json.dumps(out))
    return out


def host_costs(res, phi, g_phi, ckw, gen, dev) -> None:
    """Host µs of one K2 call and one level pass at phishing's level 1."""
    # host cost at phishing's level 1 (K=2, matrix-free): one K2 call
    # through the wrapper, and one whole pass
    K = 2
    xs, ys = partitions(phi.x_train, phi.y_train, K, dev)
    nblk = xs.shape[1] // 256
    qb, v = k1_tiles(phi.x_train, phi.y_train, K, g_phi, dev)
    q_in = level_tiles(qb).reshape(K, nblk, 256, 256)
    src = gram_mod.make_kernel_source(kf.KernelSpec("rbf", g_phi), xs, ys,
                                      bm=256)
    a0 = torch.zeros(K, nblk, 512, device=dev)
    u0 = torch.zeros(K, nblk, 256, device=dev)
    v = v.reshape(K, nblk, 256)
    d = torch.randn(K, nblk * 256, generator=gen).to(dev)
    kw = dict(ckw, mscale=float(phi.x_train.shape[0] // K))
    # the least of five rounds: other work on a shared host only adds time
    res["host_us_k2_phishing_l1"] = min(
        _host_us(lambda: src.matvec(d), 100) for _ in range(5))
    res["host_us_pass_phishing_l1"] = min(
        _host_us(lambda: cdk.fused_cd_pass(q_in, src, a0, u0, v, **kw), 40)
        for _ in range(5))
    del xs, ys, qb, q_in, src, a0, u0, v, d


def k4_times(res, phi, g_phi, rounds, dev) -> None:
    """K4 at the cascade's level 3 and at a merged node (chip_smoke 2c)."""
    p_cas = ODMParams(lam=100.0, theta=0.1, ups=0.5)
    m3 = phi.x_train.shape[0] // 8
    rbf = dict(kind="rbf", gamma=g_phi, degree=3, coef0=1.0)
    x3, y3 = (t[:8 * m3].to(dev) for t in (phi.x_train, phi.y_train))
    q3 = gram_mod.gram(x3.reshape(8, m3, -1), None, y3.reshape(8, m3),
                       **rbf)
    kw3 = dict(mscale=float(m3), tol=1e-4, max_sweeps=100)
    r3 = dual_cd.launch_solve(q3, p_cas, **kw3)
    a_warm = torch.cat([r3.alpha[:2, :m3].reshape(1, -1),
                        r3.alpha[:2, m3:].reshape(1, -1)], dim=1)
    q2 = gram_mod.gram(x3[None, :2 * m3], None, y3[None, :2 * m3], **rbf)
    kw2 = dict(mscale=float(2 * m3), alpha0=a_warm.contiguous(), tol=1e-4,
               max_sweeps=100)
    for name, q, kw in (("k4_cascade_l3", q3, kw3),
                        ("k4_merged_warm", q2, kw2)):
        call = lambda: dual_cd.launch_solve(q, p_cas, **kw)
        res[name + "_sweeps"] = call().sweeps.tolist()
        res[name + "_ms"] = statistics.median(
            _ms(call, 3) for _ in range(rounds))


def b7_times(res, gen, rounds, dev) -> None:
    """B7 at SUSY's anchor and at gisette's width, device time."""
    susy = synthetic.load("SUSY")
    gkw = dict(lam=100.0, theta=0.1, ups=0.5)
    xw = torch.rand(4800, 5000, generator=gen).to(dev)
    yw = torch.sign(torch.randn(4800, generator=gen)).to(dev)
    ww = (torch.randn(5000, generator=gen) / 50.0).to(dev)
    xs_, ys_ = susy.x_train.to(dev), susy.y_train.to(dev)
    w18 = (torch.randn(18, generator=gen) / 18 ** 0.5).to(dev)
    for name, w_, x_, y_, reps in (("b7_susy", w18, xs_, ys_, 20),
                                   ("b7_wide", ww, xw, yw, 200)):
        res[name + "_ms"] = statistics.median(
            _ms(lambda: og.launch_odm_grad(w_, x_, y_, **gkw), reps,
                hold=True) for _ in range(rounds))


def cascade_fit(res, phi, g_phi) -> None:
    """The cascade route on phishing as chip_smoke.py phase 8 fits it."""
    import dataclasses
    from repro_torch.api import ODMEstimator, ProblemSpec
    from repro_torch.core.sodm import SODMConfig
    cfg = dataclasses.replace(
        SODMConfig(p=2, levels=3, n_landmarks=8, tol=1e-4, max_sweeps=200),
        max_sweeps=100, engine=None)
    est = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("rbf", g_phi),
                                   params=ODMParams(lam=100.0)),
                       route="cascade", cfg=cfg)
    times = []
    for _ in range(4):  # the first fit warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.fit(phi.x_train, phi.y_train, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    f = est.decision_function(phi.x_test)
    res["cascade_fit_s"] = min(times[1:])
    res["cascade_test_acc"] = float(
        (torch.sign(f).cpu() == phi.y_test).float().mean())
    res["cascade_f_sum"] = float(f.double().sum())


if __name__ == "__main__":
    main()
