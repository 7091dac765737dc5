"""LM training in repro_torch against the JAX reference: the optimizers,
``loss_fn`` and its gradients, one ``make_train_step``, grad
accumulation, the remat modes, the training launcher with resume, train
state checkpoints, stratified sharding; the dense smoke configs and the
recurrent families' (falcon-mamba-7b: the chunked selective scan's
hand-written backward; recurrentgemma-9b: the RG-LRU's reverse scan and
the local attention's F and N1).

Weights come from one draw of the reference's ``init_params`` and cross
with ``interop``; batches are drawn with numpy from a seed. Bands:

* optimizers: 1e-6 relative (the same fp32 arithmetic; XLA and PyTorch
  may differ in the last bit of pow, cos and sqrt);
* ``loss_fn`` with ``compute_dtype="float32"``: the loss 1e-5 relative,
  every gradient leaf 1e-4 × max|leaf|; bf16 compute: the worst of five
  seeds at most 0.05 × max|leaf| (the frameworks round bf16 matmuls and
  their gradients at other places; measured worst in the module
  docstring of ``repro_torch.models.layers``; falcon-mamba-7b 0.035,
  recurrentgemma-9b 0.0496, spread over the recurrent gates' leaves);
* one train step (fp32 compute): the metrics 1e-5 relative; m and v 1e-4
  × max|leaf|. Adam's first step is about lr · sign(g), so a parameter
  whose gradient is near 0 may move by up to 2 lr on one side and not
  the other: every parameter is held within 2 lr (+ 1e-6 |p|), and those
  whose reference gradient is at least 1e-3 of their leaf's largest
  within 1e-6 (|p| + lr). The same bands for one grad_accum=4 step;
* grad accumulation against the full batch (fp32 compute): m and v 1e-5
  × max|leaf|, the loss and grad norm 1e-5 relative. The first step's
  parameters move by about lr · sign(g) and cannot show a wrong gradient;
  m can.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jM
from repro.optim import adamw as jadamw
from repro.optim import compress as jcomp
from repro.optim import svrg as jsvrg
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.analysis import launch_lint as ll
from repro_torch.core import partition as tpart
from repro_torch.data import lm as tlm
from repro_torch.data import stratified as tstrat
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tL
from repro_torch.models import model as tM
from repro_torch.models import transformer as tT
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcomp
from repro_torch.optim import svrg as tsvrg
from repro_torch.optim.adamw import leaves
from repro_torch.train import steps as tsteps

DENSE = ["qwen3-0.6b", "smollm-135m", "granite-8b", "qwen2.5-14b"]
RECURRENT = ["falcon-mamba-7b", "recurrentgemma-9b"]


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


def _cfgs(arch, compute_dtype, **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch),
                                compute_dtype=compute_dtype, **kw),
            dataclasses.replace(tconfigs.get_smoke(arch),
                                compute_dtype=compute_dtype, **kw))


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1)], axis=1)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)})


def _ref_params(cfg_j, seed):
    p, _ = jM.init_params(jax.random.PRNGKey(seed), cfg_j)
    return p


def _port_tree(cfg_t, ref_tree):
    """A reference parameter-shaped pytree as the port's leaves."""
    return leaves(interop.lm_params_from_numpy(
        cfg_t, jax.tree.map(np.asarray, ref_tree), device="cpu"))


def _leaf_err(got, want):
    """max over leaves of max|got - want| / max|want|."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        g, w = g.detach().float().numpy(), w.numpy()
        worst = max(worst, float(np.abs(g - w).max())
                    / max(float(np.abs(w).max()), 1e-30))
    return worst


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def test_adamw_update_schedule_and_clip_match_reference():
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((5, 3)).astype(np.float32),
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    cfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                             grad_clip=0.5)
    tcfg = tadamw.AdamWConfig(**dataclasses.asdict(cfg))
    jp = jax.tree.map(jnp.asarray, p)
    tp = {"a": torch.tensor(p["a"]), "b": {"c": torch.tensor(p["b"]["c"])}}
    js, ts = jadamw.init(jp), tadamw.init(tp)
    for i in range(5):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32) * (3.0 if i == 1 else 0.1), p)
        jp, js, jm = jadamw.update(cfg, js, jp, jax.tree.map(jnp.asarray, g))
        tg = {"a": torch.tensor(g["a"]), "b": {"c": torch.tensor(g["b"]["c"])}}
        tp, ts, tm = tadamw.update(tcfg, ts, tp, tg)
        for k in ("grad_norm", "lr"):
            assert _rel(tm[k], jm[k]) <= 1e-6, (i, k)
        assert int(ts.step) == int(js.step)
        for got, want in zip(leaves(tp) + leaves(ts.m) + leaves(ts.v),
                             jax.tree.leaves(jp) + jax.tree.leaves(js.m)
                             + jax.tree.leaves(js.v)):
            w = np.asarray(want)
            assert np.abs(got.numpy() - w).max() <= 1e-6 * max(
                1.0, np.abs(w).max()), i
    for s in (0, 1, 3, 6, 9):
        assert _rel(tadamw.schedule(tcfg, torch.tensor(s, dtype=torch.int32)),
                    jadamw.schedule(cfg, jnp.int32(s))) <= 1e-6 or s == 0
    assert float(tadamw.schedule(tcfg, torch.tensor(0))) == 0.0


@pytest.mark.parametrize("codec", ["topk", "int8"])
def test_compress_codecs_and_error_feedback_match_reference(codec):
    rng = np.random.default_rng(1)
    # ties in |g| (the top-k boundary falls inside a run of equal values)
    g0 = np.array([0.5, -0.5, 0.5, 0.25, -0.5, 0.1, 0.0, 0.5],
                  np.float32)
    g1 = rng.standard_normal(64).astype(np.float32)
    cfg = jcomp.CompressConfig(codec=codec, topk_frac=0.25)
    tcfg = tcomp.CompressConfig(codec=codec, topk_frac=0.25)
    js = jcomp.init({"x": g0, "y": g1})
    ts = tcomp.init({"x": torch.tensor(g0), "y": torch.tensor(g1)})
    for step in range(3):
        g = {"x": g0 * (step + 1), "y": g1 + step}
        jo, js = jcomp.compress(cfg, js, jax.tree.map(jnp.asarray, g))
        to, ts = tcomp.compress(tcfg, ts, {k: torch.tensor(v)
                                           for k, v in g.items()})
        for k in ("x", "y"):
            assert np.array_equal(to[k].numpy() != 0,
                                  np.asarray(jo[k]) != 0), (step, k)
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts.residual[k].numpy(),
                                       np.asarray(js.residual[k]),
                                       rtol=1e-6, atol=1e-6)
    assert tcomp.wire_ratio(tcfg) == jcomp.wire_ratio(cfg)
    out, st = tcomp.compress(tcomp.CompressConfig(), ts, {"x": torch.ones(2)})
    assert st is ts and torch.equal(out["x"], torch.ones(2))


def test_svrg_correction_matches_reference():
    rng = np.random.default_rng(2)
    arr = lambda: rng.standard_normal(6).astype(np.float32)  # noqa: E731
    p, full, g, ga = ({"w": arr()} for _ in range(4))
    js = jsvrg.refresh(jsvrg.init(p, p), p, jax.tree.map(jnp.asarray, full))
    tp = {"w": torch.tensor(p["w"])}
    ts = tsvrg.refresh(tsvrg.init(tp, tp), tp, {"w": torch.tensor(full["w"])})
    jo, js = jsvrg.correct(js, jax.tree.map(jnp.asarray, g),
                           jax.tree.map(jnp.asarray, ga))
    to, ts = tsvrg.correct(ts, {"w": torch.tensor(g["w"])},
                           {"w": torch.tensor(ga["w"])})
    np.testing.assert_allclose(to["w"].numpy(), np.asarray(jo["w"]),
                               rtol=1e-6)
    assert int(ts.age) == int(js.age) == 1
    tp["w"].add_(1.0)                    # the anchor is a snapshot
    assert torch.equal(ts.anchor_params["w"], torch.tensor(p["w"]))


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

def _loss_and_grads(cfg_j, cfg_t, seeds, impl_t="flash_xla"):
    """For each seed: ((port loss, metrics, grads), (reference loss,
    metrics, grads as the port's leaves)); the reference's value_and_grad
    is compiled once."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jM.loss_fn(p, b, cfg_j, impl="flash_xla"),
        has_aux=True))
    out = []
    for seed in seeds:
        pj = _ref_params(cfg_j, seed)
        jb, tb = _batch(cfg_t, 2, 24, seed + 100)
        (lj, mj), gj = fn(pj, jb)
        pt = interop.lm_params_from_numpy(
            cfg_t, jax.tree.map(np.asarray, pj), device="cpu",
            trainable=True)
        lt, mt = tM.loss_fn(pt, tb, cfg_t, impl=impl_t)
        gt = torch.autograd.grad(lt, leaves(pt))
        out.append(((lt.detach(), mt, gt),
                    (lj, mj, _port_tree(cfg_t, gj))))
    return out


@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_loss_and_grads_match_reference_fp32(arch):
    cfg_j, cfg_t = _cfgs(arch, "float32")
    [((lt, mt, gt), (lj, mj, gj))] = _loss_and_grads(cfg_j, cfg_t, [0])
    assert _rel(lt, lj) <= 1e-5
    for k in ("nll", "ppl_proxy"):
        assert _rel(mt[k], mj[k]) <= 1e-5, k
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0
    assert _leaf_err(gt, gj) <= 1e-4
    # the fp32 weights get fp32 gradients through apply_dense's cast
    assert all(g.dtype == torch.float32 for g in gt)


@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_loss_and_grads_bf16_worst_of_five_seeds(arch):
    cfg_j, cfg_t = _cfgs(arch, "bfloat16")
    worst = max(_leaf_err(t[2], r[2])
                for t, r in _loss_and_grads(cfg_j, cfg_t, range(5)))
    print(f"{arch}: bf16 worst gradient leaf error {worst:.4f} of max")
    assert worst <= 0.05, worst


def test_ref_attention_grads_match_flash_xla():
    """impl="ref" (plain autograd through the O(T·S) attention) and
    flash_xla (F and N1's plain versions) give the same loss and
    gradients on the same weights."""
    _, cfg = _cfgs("qwen3-0.6b", "float32")
    p = tM.init_params(cfg, generator=torch.Generator().manual_seed(3),
                       device="cpu", trainable=True)
    _, tb = _batch(cfg, 2, 24, 103)
    out = {}
    for impl in ("flash_xla", "ref"):
        loss, _ = tM.loss_fn(p, tb, cfg, impl=impl)
        out[impl] = (loss.detach(), torch.autograd.grad(loss, leaves(p)))
    assert _rel(out["ref"][0], out["flash_xla"][0]) <= 1e-6
    assert _leaf_err(out["ref"][1], out["flash_xla"][1]) <= 1e-5


def test_bf16_residual_cotangents_are_bf16():
    """The reference's precision_boundary contract: a bf16 activation's
    cotangent is bf16; fp32 weights cast to bf16 per call get fp32
    gradients."""
    x = torch.randn(2, 3, 8, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    y = x + tL.apply_dense({"w": w}, x, torch.bfloat16)
    gx, gw = torch.autograd.grad(y.float().square().sum(), (x, w))
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _carry(cfg_t, state_j):
    return interop.train_state_from_numpy(
        cfg_t, jax.tree.map(np.asarray, state_j), device="cpu")


def _train_step_matches_reference(arch, seed, batch_seed, m_floor=0.0):
    cfg_j, cfg_t = _cfgs(arch, "float32")
    pj = _ref_params(cfg_j, seed)
    sj = jsteps.TrainState.create(pj, use_ef=False)
    st = _carry(cfg_t, sj)
    jb, tb = _batch(cfg_t, 2, 16, batch_seed)
    sj, mj = jax.jit(jsteps.make_train_step(cfg_j, jsteps.TrainConfig()))(
        sj, jb)
    st, mt = tsteps.make_train_step(cfg_t, tsteps.TrainConfig())(st, tb)
    assert set(mt) == set(mj) == {"nll", "aux", "ppl_proxy", "grad_norm",
                                  "lr", "loss"}
    for k in mt:
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-5 * max(
            abs(float(mj[k])), 1e-30), k
    lr = float(mj["lr"])
    m_ref = _port_tree(cfg_t, sj["opt"].m)
    assert _leaf_err(leaves(st["opt"].m), m_ref) <= 1e-4
    assert _leaf_err(leaves(st["opt"].v),
                     _port_tree(cfg_t, sj["opt"].v)) <= 1e-4
    flipped = 0
    for p, want, m in zip(leaves(st["params"]),
                          _port_tree(cfg_t, sj["params"]), m_ref):
        d = (p.detach() - want).abs()
        assert bool((d <= 2 * lr + 1e-6 * want.abs()).all())
        firm = m.abs() >= max(1e-3 * float(m.abs().max()), m_floor)
        assert bool((d <= 1e-6 * (want.abs() + lr))[firm].all())
        flipped += int((d > 1e-6 * (want.abs() + lr)).sum())
    assert int(st["opt"].step) == 1
    assert flipped < 0.01 * sum(p.numel() for p in leaves(st["params"]))


def test_train_step_matches_reference():
    _train_step_matches_reference("granite-8b", 1, 5)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_train_step_matches_reference(arch):
    """``test_train_step_matches_reference`` on the ssm and hybrid smoke
    configs: mamba's A_log and D, the RG-LRU's gates and Λ, the local
    attention, all through one AdamW step. A parameter is held within
    1e-6 where Adam's step is about lr · sign(g), so its gradient must
    also clear 10 eps (m = 0.1 g >= 1e-8): mamba's A_log has gradients of
    1e-10 to 1e-7 at init, where the step is lr · g / (|g| + eps) and
    shows g's own last digits (1e-5 of it; the leaf is held by m within
    1e-4 of its max like every other)."""
    _train_step_matches_reference(arch, 1, 5, m_floor=1e-8)


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_matches_full_batch(accum):
    """The reference's test_accum_matches_full_batch, on the port, held
    where a fault would show. Adam's first step moves every parameter by
    about lr · sign(g) ≈ 3e-6, so the parameters cannot tell a wrong
    gradient from a right one; the first moment m is (1 - b1) times the
    clipped mean gradient and can. With fp32 compute the microbatched m
    and v equal the full batch's within 1e-5 × max|leaf| (measured
    ~1e-6); summing without dividing, dropping a microbatch or a sign
    flip moves m by O(1) of its max."""
    cfg = dataclasses.replace(tconfigs.get_smoke("granite-8b"),
                              compute_dtype="float32")
    batch = tlm.batch_at(tlm.LMDataConfig(vocab=cfg.vocab, seq_len=16,
                                          global_batch=8), 0, device="cpu")
    out = []
    for n in (1, accum):
        p = tM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", trainable=True)
        state = tsteps.TrainState.create(p, use_ef=False)
        tc = tsteps.TrainConfig(grad_accum=n)
        out.append(tsteps.make_train_step(cfg, tc)(state, batch))
    (full, mf), (micro, mm) = out
    # nll and ppl_proxy are the last microbatch's, as in the reference
    for k in ("loss", "grad_norm"):
        assert _rel(mm[k], mf[k]) <= 1e-5, k
    assert _leaf_err(leaves(micro["opt"].m), leaves(full["opt"].m)) <= 1e-5
    assert _leaf_err(leaves(micro["opt"].v), leaves(full["opt"].v)) <= 1e-5
    d = max(float((a - b).abs().max().detach()) for a, b in zip(
        leaves(full["params"]), leaves(micro["params"])))
    assert d < 1e-4


def test_grad_accum_step_matches_reference():
    """One grad_accum=4 step against the reference's, from one carried-over
    state (fp32 compute): the metrics 1e-5 relative, m and v 1e-4 ×
    max|leaf|, as for the single-batch step."""
    cfg_j, cfg_t = _cfgs("granite-8b", "float32")
    sj = jsteps.TrainState.create(_ref_params(cfg_j, 2), use_ef=False)
    st = _carry(cfg_t, sj)
    jb, tb = _batch(cfg_t, 8, 16, 6)
    tc_j = jsteps.TrainConfig(grad_accum=4)
    sj, mj = jax.jit(jsteps.make_train_step(cfg_j, tc_j))(sj, jb)
    st, mt = tsteps.make_train_step(
        cfg_t, tsteps.TrainConfig(grad_accum=4))(st, tb)
    for k in mt:
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-5 * max(
            abs(float(mj[k])), 1e-30), k
    assert _leaf_err(leaves(st["opt"].m), _port_tree(cfg_t, sj["opt"].m)) \
        <= 1e-4
    assert _leaf_err(leaves(st["opt"].v), _port_tree(cfg_t, sj["opt"].v)) \
        <= 1e-4


def _remat_runs(arch):
    """Each remat mode's loss and gradients on one batch, and F's calls."""
    cfg = tconfigs.get_smoke(arch)
    _, tb = _batch(cfg, 2, 16, 9)
    got, calls = {}, {}
    for mode in ("none", "full", "dots", "attn"):
        c = dataclasses.replace(cfg, remat=mode)
        p = tM.init_params(c, generator=torch.Generator().manual_seed(0),
                           device="cpu", trainable=True)

        def run():
            loss, _ = tM.loss_fn(p, tb, c)
            return loss, torch.autograd.grad(loss, leaves(p))
        got[mode], sites = ll.run(run)
        calls[mode] = ll.count(sites, "flash_attention_train")
    for mode in ("full", "dots", "attn"):
        assert torch.equal(got[mode][0], got["none"][0]), mode
        assert all(torch.equal(a, b) for a, b in zip(got[mode][1],
                                                     got["none"][1])), mode
    return cfg, calls


def test_remat_modes_are_bit_identical_and_attn_skips_the_flash_recompute():
    cfg, calls = _remat_runs("qwen3-0.6b")
    n = cfg.n_layers
    assert calls == {"none": n, "full": 2 * n, "dots": 2 * n, "attn": n}


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_remat_modes_are_bit_identical(arch):
    """The four remat modes on the ssm and hybrid smoke configs, bit for
    bit: the custom backwards (mamba's chunked scan, affine_scan's
    reverse scan) recompute under checkpointing as they ran. F runs once
    a local-attention layer, twice where the mode recomputes it."""
    cfg, calls = _remat_runs(arch)
    n = tT.layer_kinds(cfg).count("attn")
    assert n == (1 if arch == "recurrentgemma-9b" else 0)
    assert calls == {"none": n, "full": 2 * n, "dots": 2 * n, "attn": n}


def test_train_step_with_compression_runs_the_codec():
    cfg = tconfigs.get_smoke("smollm-135m")
    _, tb = _batch(cfg, 2, 8, 4)
    p = tM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu", trainable=True)
    state = tsteps.TrainState.create(p, use_ef=True)
    tc = tsteps.TrainConfig(compression=tcomp.CompressConfig(codec="int8"))
    state, mets = tsteps.make_train_step(cfg, tc)(state, tb)
    assert math.isfinite(float(mets["loss"]))
    assert any(bool(r.abs().max() > 0) for r in leaves(state["ef"].residual))


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

def test_train_state_checkpoint_roundtrip(tmp_path):
    cfg = tconfigs.get_smoke("qwen3-0.6b")
    p = tM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu", trainable=True)
    state = tsteps.TrainState.create(p, use_ef=True)
    _, tb = _batch(cfg, 1, 8, 0)
    state, _ = tsteps.make_train_step(cfg, tsteps.TrainConfig())(state, tb)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, state, {"data_step": 1, "arch": cfg.name})
    mgr.save_async(2, state, {"data_step": 2, "arch": cfg.name})
    mgr.wait()
    assert mgr.metadata()["metadata"] == {"data_step": 2, "arch": cfg.name}
    keys = set(mgr.metadata()["leaves"])
    assert "opt/step" in keys and "opt/m/embed/table" in keys
    fresh = tsteps.TrainState.create(
        tM.init_params(cfg, generator=torch.Generator().manual_seed(1),
                       device="cpu", trainable=True), use_ef=True)
    back = mgr.restore(fresh)
    assert isinstance(back["opt"], tadamw.AdamWState)
    assert isinstance(back["ef"], tcomp.EFState)
    assert all(q.requires_grad for q in back["params"].parameters())
    def flat(st):
        return (leaves(st["params"]) + leaves(st["opt"].m)
                + leaves(st["opt"].v) + leaves(st["ef"].residual)
                + [st["opt"].step])
    for a, b in zip(flat(back), flat(state), strict=True):
        assert torch.equal(a.detach(), b.detach())


def _launcher_resume(tmp_path, capsys, arch):
    base = ["--arch", arch, "--seq-len", "16", "--global-batch",
            "2", "--device", "cpu"]
    straight, l_all = ttrain.train(ttrain.parse(
        base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")]))
    ttrain.train(ttrain.parse(base + ["--steps", "2", "--ckpt-every", "2",
                                      "--ckpt-dir", str(tmp_path / "b")]))
    resumed, l_b = ttrain.train(ttrain.parse(
        base + ["--steps", "4", "--resume", "--ckpt-dir",
                str(tmp_path / "b")]))
    assert "resumed from step 2" in capsys.readouterr().out
    assert l_b == l_all[2:]
    for a, b in zip(leaves(straight["params"]), leaves(resumed["params"])):
        assert torch.equal(a.detach(), b.detach())
    for a, b in zip(leaves(straight["opt"].m) + leaves(straight["opt"].v),
                    leaves(resumed["opt"].m) + leaves(resumed["opt"].v)):
        assert torch.equal(a, b)
    assert ttrain.main(base + ["--steps", "1"]) == 0


def test_launcher_resume_is_bit_identical(tmp_path, capsys):
    _launcher_resume(tmp_path, capsys, "smollm-135m")


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_launcher_resume_is_bit_identical(tmp_path, capsys, arch):
    """launch/train on the ssm and hybrid smoke configs: 4 steps straight
    against 2, a checkpoint, and --resume for 2 more, bit for bit
    (parameters and AdamW's m and v, mamba's A_log and D among them)."""
    _launcher_resume(tmp_path, capsys, arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_overfit_tiny_batch(arch):
    """The reference's test_overfit_tiny_batch recipe on the port: 8
    steps of AdamW (lr 1e-3, one warm-up step) on one batch lower the
    loss."""
    cfg = tconfigs.get_smoke(arch)
    _, tb = _batch(cfg, 2, 16, 7)
    p = tM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu", trainable=True)
    state = tsteps.TrainState.create(p, use_ef=False)
    step = tsteps.make_train_step(cfg, tsteps.TrainConfig(
        optimizer=tadamw.AdamWConfig(lr=1e-3, warmup_steps=1)))
    losses = []
    for _ in range(8):
        state, mets = step(state, tb)
        losses.append(float(mets["loss"]))
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_accum_codec_and_checkpoint(tmp_path, arch):
    """grad_accum=2 against the full batch of 2 (m within 1e-5 of each
    leaf's max, as test_grad_accum_matches_full_batch), a step through the
    int8 EF codec, and the train state's checkpoint round trip (mamba's
    MixedDict parameters and their opt/m, opt/v leaves) bit for bit."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch),
                              compute_dtype="float32")
    _, tb = _batch(cfg, 2, 16, 8)
    out = []
    for n in (1, 2):
        p = tM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", trainable=True)
        st = tsteps.TrainState.create(p, use_ef=False)
        out.append(tsteps.make_train_step(
            cfg, tsteps.TrainConfig(grad_accum=n))(st, tb))
    (full, mf), (micro, mm) = out
    assert _rel(mm["loss"], mf["loss"]) <= 1e-5
    assert _leaf_err(leaves(micro["opt"].m), leaves(full["opt"].m)) <= 1e-5
    p = tM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu", trainable=True)
    state = tsteps.TrainState.create(p, use_ef=True)
    tc = tsteps.TrainConfig(compression=tcomp.CompressConfig(codec="int8"))
    state, mets = tsteps.make_train_step(cfg, tc)(state, tb)
    assert math.isfinite(float(mets["loss"]))
    assert any(bool(r.abs().max() > 0) for r in leaves(state["ef"].residual))
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, state, {"data_step": 1, "arch": cfg.name})
    keys = set(mgr.metadata()["leaves"])
    if arch == "falcon-mamba-7b":
        assert {"opt/m/stack/layers/0/ssm/A_log",
                "opt/v/stack/layers/0/ssm/D"} <= keys
    fresh = tsteps.TrainState.create(
        tM.init_params(cfg, generator=torch.Generator().manual_seed(1),
                       device="cpu", trainable=True), use_ef=True)
    back = mgr.restore(fresh)
    assert all(q.requires_grad for q in back["params"].parameters())

    def flat(st):
        return (leaves(st["params"]) + leaves(st["opt"].m)
                + leaves(st["opt"].v) + leaves(st["ef"].residual)
                + [st["opt"].step])
    for a, b in zip(flat(back), flat(state), strict=True):
        assert torch.equal(a.detach(), b.detach())


# ---------------------------------------------------------------------------
# stratified data-parallel sharding
# ---------------------------------------------------------------------------

def _clustered(M=256, d=4, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 3.0
    lab = rng.integers(0, k, M)
    return (centers[lab] + rng.normal(size=(M, d))).astype(np.float32)


def test_stratified_skew_below_random_skew():
    """The reference's test_stratified_beats_random_on_skew, on the
    port."""
    x = _clustered()
    tx = torch.tensor(x)
    perm = tstrat.assign_ranks(tx, 8, n_landmarks=4, seed=0)
    assert sorted(perm.tolist()) == list(range(256))
    rnd = tpart.random_partitions(256, 8, 1)
    s1 = float(tstrat.distribution_skew(tx, perm, 8))
    s2 = float(tstrat.distribution_skew(tx, rnd, 8))
    assert s1 <= s2 * 1.25
    with pytest.raises(ValueError, match="must divide"):
        tstrat.assign_ranks(tx[:250], 8)
