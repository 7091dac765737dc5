"""The cascade (Ca-ODM) on phishing in both packages, from one layout.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_parity_cascade_phishing.py [scale]

Fits phishing at ``scale`` (default 0.25; rbf at the median gamma,
lam = 100, ``benchmarks/table2_rbf.py``'s ``CFG_CASCADE``: levels = 3,
max_sweeps = 100) with repro_torch on the CPU, then runs the reference's
cascade on the same leaf permutation. Prints each package's per-level
sweeps and KKT (the port's), fit seconds, survivors in common, max
|Δalpha| and test accuracy beside the majority rate: at lam = 100 the
levels stop at the sweep cap far from tol and both packages fall below
the majority rate. About 20 s of CPU at the default scale; not part of
the suite (pytest does not collect it).
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import baselines as jb
from repro.core import kernel_fns as jkf
from repro.core.odm import ODMParams as JParams
from repro.serve import model as jmodel
from repro_torch.core import baselines as tb
from repro_torch.core import kernel_fns as tkf
from repro_torch.core import partition as tpart
from repro_torch.core.odm import ODMParams
from repro_torch.data import synthetic
from repro_torch.serve import model as tmodel


class _Levels:
    def log_metrics(self, step, m):
        print(f"  port level {m['level']} K={m['K']} m={m['m']}: "
              f"sweeps={m['sweeps']} kkt={m['kkt']:.3e} "
              f"seconds={m['wall_s']:.2f}", flush=True)


def main(scale: float) -> None:
    ds = synthetic.load("phishing", scale=scale)
    gamma = tkf.median_gamma(ds.x_train)
    M = ds.x_train.shape[0]
    perm = tpart.random_partitions(M, 8, 0)
    major = float(max((ds.y_test > 0).float().mean(),
                      (ds.y_test < 0).float().mean()))
    kw = dict(levels=3, tol=1e-4, max_sweeps=100)
    print(f"phishing scale {scale}: M={M}, gamma={gamma:.6g}, "
          f"majority {major:.4f}", flush=True)

    t0 = time.perf_counter()
    got = tb._cascade_solve(tkf.KernelSpec("rbf", gamma), ds.x_train,
                            ds.y_train, ODMParams(100.0, 0.1, 0.5),
                            perm=perm, tracker=_Levels(), **kw)
    f = tmodel.from_cascade(tkf.KernelSpec("rbf", gamma),
                            got).decision_function(ds.x_test)
    acc_t = float((torch.sign(f) == ds.y_test).float().mean())
    print(f"port: {time.perf_counter() - t0:.1f} s, test accuracy "
          f"{acc_t:.4f}", flush=True)

    t0 = time.perf_counter()
    want = jb._cascade_solve(
        jkf.KernelSpec("rbf", gamma), jnp.asarray(ds.x_train.numpy()),
        jnp.asarray(ds.y_train.numpy()), JParams(100.0, 0.1, 0.5),
        key=jax.random.PRNGKey(0), perm=jnp.asarray(perm.numpy()), **kw)
    fj = jmodel.from_cascade(jkf.KernelSpec("rbf", gamma),
                             want).decision_function(
        jnp.asarray(ds.x_test.numpy()))
    acc_j = float(np.mean(np.sign(np.asarray(fj)) == ds.y_test.numpy()))
    print(f"reference: {time.perf_counter() - t0:.1f} s, test accuracy "
          f"{acc_j:.4f}", flush=True)
    same = int(np.sum(np.all(got.x_sv.numpy() == np.asarray(want.x_sv),
                             axis=1)))
    d_alpha = float(np.abs(got.alpha.numpy() - np.asarray(want.alpha)).max())
    print(f"survivors in the same place: {same} of {got.x_sv.shape[0]}; "
          f"max |dalpha| = {d_alpha:.3e}")


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 0.25)
