"""Both packages on the hardest partitions of phishing's first two levels.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_parity_phishing_levels.py

Fits phishing (full size, rbf at the median gamma, lam = 100, the
``chip_smoke.py`` configuration) with repro_torch on the CPU up to level 2,
keeping each level's inputs. For the partition with the largest final
KKT at levels 3 and 2, it then runs the same inputs (warm start included)
through both packages' pallas engine, K = 1, at the configuration's
200-pass cap and at twice the cap, and prints passes, KKT and
max |Δalpha|. The reference runs in interpret mode, as on any CPU. About
five minutes of CPU; not part of the suite (pytest does not collect it).
"""
import sys
import time

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import engines as jeng
from repro.core import kernel_fns as jkf
from repro.core.odm import ODMParams as JParams
from repro_torch.api import ODMEstimator, ProblemSpec
from repro_torch.core import engines as teng
from repro_torch.core import kernel_fns as tkf
from repro_torch.core.odm import ODMParams
from repro_torch.core.sodm import SODMConfig
from repro_torch.data import synthetic

LEVELS = 2          # levels 3 and 2, the dense ones
PARAMS = dict(lam=100.0, theta=0.1, ups=0.5)
CFG = SODMConfig(p=2, levels=3, n_landmarks=8, tol=1e-4, max_sweeps=200,
                 engine="pallas")


class _Enough(Exception):
    pass


def record_levels(ds, gamma):
    """The port's first LEVELS level inputs, as numpy, and their KKTs."""
    rec = []
    solve = teng.solve_level_pallas

    def spy(xs, ys, alphas, **kw):
        out = solve(xs, ys, alphas, **kw)
        rec.append((xs.numpy().copy(), ys.numpy().copy(),
                    alphas.numpy().copy(), out[2].numpy().copy()))
        if len(rec) == LEVELS:
            raise _Enough
        return out

    teng.solve_level_pallas = spy
    try:
        ODMEstimator(ProblemSpec(kernel=tkf.KernelSpec("rbf", gamma),
                                 params=ODMParams(**PARAMS)),
                     cfg=CFG, device="cpu").fit(ds.x_train, ds.y_train, 0)
    except _Enough:
        pass
    finally:
        teng.solve_level_pallas = solve
    return rec


def main() -> None:
    ds = synthetic.load("phishing")
    gamma = float(tkf.median_gamma(ds.x_train))
    for i, (xs, ys, a, kkts) in enumerate(record_levels(ds, gamma)):
        k = int(np.argmax(kkts))
        level = CFG.levels - i
        print(f"level {level}: K={xs.shape[0]} m={xs.shape[1]}, the fit's "
              f"KKTs {np.array2string(kkts, precision=3)}; partition {k}",
              flush=True)
        xs, ys, a = xs[k:k + 1], ys[k:k + 1], a[k:k + 1]
        for cap in (CFG.max_sweeps, 2 * CFG.max_sweeps):
            kw = dict(tol=CFG.tol, max_sweeps=cap, block=CFG.block)
            t0 = time.perf_counter()
            ja, js, jk = jeng.solve_level_pallas(
                jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(a),
                spec=jkf.KernelSpec("rbf", gamma), params=JParams(**PARAMS),
                **kw)
            t1 = time.perf_counter()
            ta, ts, tk = teng.solve_level_pallas(
                torch.tensor(xs), torch.tensor(ys), torch.tensor(a),
                spec=tkf.KernelSpec("rbf", gamma),
                params=ODMParams(**PARAMS), **kw)
            d = float(np.abs(np.asarray(ja) - ta.numpy()).max())
            print(f"  cap {cap}: reference passes {int(np.asarray(js)[0])} "
                  f"kkt {float(np.asarray(jk)[0]):.6e} | port passes "
                  f"{int(ts[0])} kkt {float(tk[0]):.6e} | max|dalpha| "
                  f"{d:.3e} ({t1 - t0:.0f} s, "
                  f"{time.perf_counter() - t1:.0f} s)", flush=True)


if __name__ == "__main__":
    sys.exit(main())
