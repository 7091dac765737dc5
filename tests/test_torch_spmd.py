"""The port's SPMD paths in one spawned ``gloo`` world of 4 ranks, held
against the reference's sharded solves and the port's one-process ones.

One battery, like ``tests/test_spmd.py``. First a subprocess runs the
reference's sharded solves once on 4 host devices
(``--xla_force_host_platform_device_count=4``) and hands their
permutations, duals, w and histories over as npz. Then 4 ranks (one
process each, a ``FileStore`` under the test's temporary directory) run
the port's battery on the same data:

1. sodm sharded at n_dev 2 (a (2, 2) mesh: the model axis replicates)
   and 4 (a (4, 1) mesh), with the reference's permutation patched into
   the first rank's draw: duals within 1e-5 of the reference's sharded
   solve, the dual objective within 1e-3 of the port's one-process fit
   (the reference battery's band), one gather per sharded level;
2. dsvrg sharded on both schedules, batch 3 not dividing m = 16: w and
   history within the DSVRG band (1e-5 relative) of the reference's
   sharded solve; against the port's one-process solve the objective
   within 1e-3, max|dw| <= 1e-4, eta within 1e-6; the reference's
   communication pattern in the collective counters;
3. the sodm dsvrg engine on the mesh, and ODMEstimator(mesh=...) for
   route="sodm" and route=None;
4. score_sharded against decision_function, the SVs padded to 4 slices;
5. the elastic battery of ``tests/test_elastic.py``: reshard, drift
   caught, the divisibility fallback, shrink to a 2-rank submesh and grow
   back, restore_elastic both ways; and a checkpoint saved on one mesh
   and restored on another.

Every rank also checks that its replicated results equal the first
rank's bit for bit.
"""
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro import serve
from repro.api import ODMEstimator, ProblemSpec
from repro.core import dsvrg, kernel_fns as kf, odm, sodm
from repro.launch.mesh import make_host_mesh

d = np.load(sys.argv[1])
x, y = jnp.asarray(d["x"]), jnp.asarray(d["y"])
spec = kf.KernelSpec(name="rbf", gamma=0.5)
params = odm.ODMParams()
scfg = sodm.SODMConfig(p=2, levels=3, n_landmarks=4, tol=1e-6,
                       max_sweeps=300)
out = {}
meshes = {"n2": make_host_mesh((2, 2), ("data", "model")),
          "n4": make_host_mesh((4, 1), ("data", "model"))}
for tag, mesh in meshes.items():
    r = sodm._solve_sharded(spec, x, y, params, scfg, jax.random.PRNGKey(3),
                            mesh)
    out[f"sodm_{tag}_perm"] = np.asarray(r.perm)
    out[f"sodm_{tag}_alpha"] = np.asarray(r.alpha)
    out[f"sodm_{tag}_sweeps"] = np.asarray(r.sweeps_per_level)
for sched in ("serial", "parallel"):
    dcfg = dsvrg.DSVRGConfig(n_partitions=8, epochs=4, batch=3,
                             schedule=sched, partition_strategy="identity")
    r = dsvrg._solve_sharded(x, y, params, dcfg, jax.random.PRNGKey(4),
                             meshes["n4"])
    out[f"dsvrg_{sched}_w"] = np.asarray(r.w)
    out[f"dsvrg_{sched}_hist"] = np.asarray(r.history)
    out[f"dsvrg_{sched}_eta"] = np.asarray(r.eta)
ecfg = sodm.SODMConfig(engine="dsvrg", partition_strategy="identity",
                       dsvrg=dsvrg.DSVRGConfig(n_partitions=8, epochs=6,
                                               batch=4,
                                               partition_strategy="identity"))
r = sodm._solve_sharded(kf.KernelSpec(name="linear"), x, y, params, ecfg,
                        jax.random.PRNGKey(5), meshes["n4"])
out["engine_alpha"] = np.asarray(r.alpha)
est = ODMEstimator(ProblemSpec(kernel=spec, params=params), route="sodm",
                   cfg=scfg, mesh=meshes["n2"])
_, rep = est.fit(x, y, jax.random.PRNGKey(3))
out["est_perm"] = np.asarray(rep.raw.perm)
out["est_alpha"] = np.asarray(rep.raw.alpha)
np.savez(sys.argv[2], **out)
"""

_RANK = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
rank, store, data, ref, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
from repro_torch import sharding
from repro_torch.analysis.invariants import counter
from repro_torch.api import ODMEstimator, ProblemSpec
from repro_torch.core import dsvrg, kernel_fns as kf, odm, sodm
from repro_torch.distributed import elastic
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import model as smodel, server

results = []
def check(name, cond, info=""):
    results.append((name, bool(cond), str(info)))

def same_as_rank0(name, t):
    t0 = t.detach().clone()
    dist.broadcast(t0, src=0)
    check(f"{name}: rank {rank} equals rank 0", torch.equal(t, t0))

def counts():
    return {op: counter(f"collective.{op}").count
            for op in ("psum", "pmean", "all_gather", "broadcast")}

def delta(before):
    return {k: v - before[k] for k, v in counts().items()}

def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

d, R = np.load(data), np.load(ref)
X, Y = torch.tensor(d["x"]), torch.tensor(d["y"])
M = X.shape[0]
spec = kf.KernelSpec(name="rbf", gamma=0.5)
params = odm.ODMParams()
scfg = sodm.SODMConfig(p=2, levels=3, n_landmarks=4, tol=1e-6,
                       max_sweeps=300)
meshes = {"n2": make_host_mesh((2, 2), ("data", "model")),
          "n4": make_host_mesh((4, 1), ("data", "model"))}
real_perm = sodm._sharded_perm

def dual_obj(res):
    Q = kf.signed_gram(spec, X[res.perm], Y[res.perm])
    return float(odm.dual_objective(Q, res.alpha, params, float(M)))

# -- 1. sodm sharded at n_dev 2 and 4 ------------------------------------
r1 = sodm._solve(spec, X, Y, params, scfg, 3)
o1 = dual_obj(r1)
for tag, n_dev in (("n2", 2), ("n4", 4)):
    perm = torch.tensor(R[f"sodm_{tag}_perm"], dtype=torch.int64)
    sodm._sharded_perm = lambda *a: perm
    before = counts()
    r = sodm._solve_sharded(spec, X, Y, params, scfg, 3, meshes[tag])
    got = delta(before)
    sodm._sharded_perm = real_perm
    err = float((r.alpha - torch.tensor(R[f"sodm_{tag}_alpha"])).abs().max())
    check(f"sodm {tag} duals vs the reference's sharded solve", err <= 1e-5,
          f"max|da|={err:.2e}")
    o2 = dual_obj(r)
    check(f"sodm {tag} objective vs one process", abs(o1 - o2) < 1e-3,
          f"{o1:.6f} vs {o2:.6f}")
    Ks = [2 ** (3 - i) for i in range(r.levels_run)]
    sharded = sum(1 for K in Ks if K >= n_dev and K % n_dev == 0)
    check(f"sodm {tag} one gather per sharded level",
          got == dict(psum=0, pmean=0, all_gather=sharded, broadcast=1),
          f"{got} with {sharded} sharded levels of {Ks}")
    check(f"sodm {tag} sweeps as the reference's",
          r.sweeps_per_level == list(R[f"sodm_{tag}_sweeps"]),
          f"{r.sweeps_per_level} vs {list(R[f'sodm_{tag}_sweeps'])}")
    same_as_rank0(f"sodm {tag} alpha", r.alpha)

# -- 2. dsvrg sharded, both schedules, batch 3 ---------------------------
for sched in ("parallel", "serial"):
    kw = dict(n_partitions=8, epochs=4, batch=3, schedule=sched)
    ident = dsvrg.DSVRGConfig(partition_strategy="identity", **kw)
    before = counts()
    r = dsvrg._solve_sharded(X, Y, params, ident, 4, meshes["n4"])
    got = delta(before)
    check(f"dsvrg {sched} w vs the reference's sharded solve",
          rel(r.w, R[f"dsvrg_{sched}_w"]) <= 1e-5,
          f"rel={rel(r.w, R[f'dsvrg_{sched}_w']):.2e}")
    check(f"dsvrg {sched} history vs the reference's",
          rel(r.history, R[f"dsvrg_{sched}_hist"]) <= 1e-5)
    par = sched == "parallel"
    want = dict(psum=1 + 2 * 4, pmean=4 if par else 0,
                all_gather=0 if par else 1, broadcast=1)
    check(f"dsvrg {sched} communication pattern", got == want,
          f"{got} vs {want}")
    same_as_rank0(f"dsvrg {sched} w", r.w)
    cfg = dsvrg.DSVRGConfig(**kw)
    a = dsvrg._solve(X, Y, params, cfg, 4)
    b = dsvrg._solve_sharded(X, Y, params, cfg, 4, meshes["n4"])
    dd = abs(float(a.history[-1]) - float(b.history[-1]))
    dw = float((a.w - b.w).abs().max())
    de = abs(float(a.eta) - float(b.eta))
    check(f"dsvrg {sched} objective vs one process", dd < 1e-3, f"{dd:.2e}")
    check(f"dsvrg {sched} w vs one process", dw < 1e-4, f"{dw:.2e}")
    check(f"dsvrg {sched} auto eta vs one process", de < 1e-6, f"{de:.2e}")

# -- 3. the sodm dsvrg engine and the estimator on the mesh --------------
spec_lin = kf.KernelSpec(name="linear")
ecfg = sodm.SODMConfig(engine="dsvrg", partition_strategy="identity",
                       dsvrg=dsvrg.DSVRGConfig(n_partitions=8, epochs=6,
                                               batch=4,
                                               partition_strategy="identity"))
er = sodm._solve_sharded(spec_lin, X, Y, params, ecfg, 5, meshes["n4"])
check("sodm dsvrg engine duals vs the reference's",
      rel(er.alpha, R["engine_alpha"]) <= 1e-5,
      f"rel={rel(er.alpha, R['engine_alpha']):.2e}")
e1 = sodm._solve(spec_lin, X, Y, params, ecfg, 5)
acc = lambda res: float(odm.accuracy(Y, torch.sign(
    smodel.from_sodm(spec_lin, res, X, Y).decision_function(X))))
check("sodm dsvrg engine accuracy vs one process",
      abs(acc(er) - acc(e1)) < 0.005, f"{acc(er):.4f} vs {acc(e1):.4f}")
perm = torch.tensor(R["est_perm"], dtype=torch.int64)
sodm._sharded_perm = lambda *a: perm
est = ODMEstimator(ProblemSpec(kernel=spec, params=params), route="sodm",
                   cfg=scfg, mesh=meshes["n2"])
smod, srep = est.fit(X, Y, 3)
sodm._sharded_perm = real_perm
err = float((srep.raw.alpha - torch.tensor(R["est_alpha"])).abs().max())
check("estimator sodm on the mesh vs the reference's", err <= 1e-5,
      f"{err:.2e}")
check("estimator sodm objective vs one process",
      abs(dual_obj(srep.raw) - o1) < 1e-3)
lcfg = sodm.SODMConfig(dsvrg_threshold=64, dsvrg=dsvrg.DSVRGConfig(
    n_partitions=8, epochs=6, batch=4))
lm, lrep = ODMEstimator(ProblemSpec(kernel=spec_lin, params=params),
                        cfg=lcfg, mesh=meshes["n4"]).fit(X, Y, 5)
check("estimator route=None on the mesh resolves to dsvrg",
      lrep.route == "dsvrg", lrep.route)
la = float(odm.accuracy(Y, lm.predict(X)))
check("estimator dsvrg accuracy vs the engine route", abs(la - acc(e1)) < 0.01,
      f"{la:.4f} vs {acc(e1):.4f}")

# -- 4. serving: the SV slab sharded over 4 ranks ------------------------
model = smodel.from_sodm(spec, r1, X, Y)
f_rep = model.decision_function(X[:48])
f_shd = server.score_sharded(model, X[:48], meshes["n4"])
dsv = float((f_rep - f_shd).abs().max())
check("score_sharded vs decision_function",
      dsv <= 1e-5 * float(f_rep.abs().max()),
      f"diff={dsv:.2e} n_sv={model.n_sv}")
same_as_rank0("score_sharded", f_shd)

# -- 5. elastic resharding and cross-mesh checkpoints ---------------------
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
tree = {"w": torch.arange(64.0).reshape(16, 4), "b": torch.arange(8.0),
        "step": torch.tensor(3, dtype=torch.int32)}
axes_tree = {"w": ("batch", None), "b": ("embed",), "step": ()}
mesh4 = meshes["n4"]
on4 = elastic.reshard(tree, axes_tree, mesh4)
check("reshard w placement", on4["w"].placements == (Shard(0), Replicate()),
      on4["w"].placements)
check("reshard b placement", on4["b"].placements == (Shard(0), Replicate()))
check("reshard scalar replicated",
      on4["step"].placements == (Replicate(), Replicate()))
check("reshard values", elastic.validate_resharding(tree, on4))
bad = dict(on4)
bad["b"] = on4["b"] + 1.0
check("validate catches drift", not elastic.validate_resharding(tree, bad))
odd = elastic.reshard({"v": torch.arange(6.0)}, {"v": ("batch",)}, mesh4)
check("divisibility fallback replicates",
      odd["v"].placements == (Replicate(), Replicate()))
check("fallback values",
      elastic.validate_resharding({"v": torch.arange(6.0)}, odd))
mesh2 = DeviceMesh("cpu", torch.tensor([[0], [1]]),
                   mesh_dim_names=("data", "model"))
inside = mesh2.get_coordinate() is not None
shrunk = elastic.reshard(on4, axes_tree, mesh2)
if inside:
    check("shrink to 2 ranks: values", elastic.validate_resharding(tree,
                                                                   shrunk))
    check("shrink to 2 ranks: local rows",
          tuple(shrunk["w"].to_local().shape) == (8, 4))
regrown = elastic.reshard(shrunk, axes_tree, mesh4)
check("grow back to 4 ranks: values", elastic.validate_resharding(tree,
                                                                  regrown))
check("grow back to 4 ranks: local rows",
      tuple(regrown["w"].to_local().shape) == (4, 4))
ckdir = os.path.join(os.path.dirname(store), "ckpt")
mgr = CheckpointManager(ckdir)
mgr.save(1, on4, {"mesh": "4x1"})
template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}
back2 = elastic.restore_elastic(mgr, template, axes_tree, mesh2)
if inside:
    check("restore_elastic shrink values",
          elastic.validate_resharding(tree, back2))
back4 = elastic.restore_elastic(mgr, template, axes_tree, mesh4)
check("restore_elastic grow values", elastic.validate_resharding(tree, back4))
check("restore_elastic grow placement",
      back4["w"].placements == (Shard(0), Replicate()))
mesh22 = meshes["n2"]
shard_b = sharding.tree_shardings(axes_tree, tree, mesh22)
back22 = mgr.restore(template, shardings=shard_b)
check("checkpoint saved on (4, 1), restored on (2, 2)",
      elastic.validate_resharding(tree, back22))
check("restored placement on (2, 2)",
      back22["w"].placements == (Shard(0), Replicate()))

with open(out, "w") as fh:
    json.dump(results, fh)
dist.destroy_process_group()
"""


def _data(M=128, d=5, seed=2):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal((M // 2, d)) + 1.0,
                        rng.standard_normal((M // 2, d)) - 1.0])
    y = np.concatenate([np.ones(M // 2), -np.ones(M // 2)])
    return x.astype(np.float32), y.astype(np.float32)


def test_spmd_battery(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    x, y = _data()
    data, ref = tmp_path / "data.npz", tmp_path / "ref.npz"
    np.savez(data, x=x, y=y)
    proc = subprocess.run([sys.executable, "-c", _REF, str(data), str(ref)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    env["OMP_NUM_THREADS"] = "1"
    outs = [tmp_path / f"rank{r}.json" for r in range(4)]
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(data), str(ref), str(outs[r])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        for p in ranks:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in ranks:
            p.kill()
    failed = []
    for r, (p, log) in enumerate(zip(ranks, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
        for name, ok, info in json.loads(outs[r].read_text()):
            print(f"rank {r} {'PASS' if ok else 'FAIL'} {name} {info}")
            if not ok:
                failed.append(f"rank {r}: {name} ({info})")
    assert not failed, failed
