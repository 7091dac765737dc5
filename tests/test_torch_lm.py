"""The LM scaffold's serving path in repro_torch against the JAX reference:
the dense families, and the ssm (falcon-mamba) and hybrid
(recurrentgemma: RG-LRU and local attention) families.

Weights come from one draw of the reference's ``init_params`` and cross
with ``interop.lm_params_from_numpy``; inputs are drawn with numpy from a
seed. Bands: fp32 pieces to 1e-5 (layers, attention) and whole-model
logits at ``compute_dtype="float32"`` to 1e-4 of max|logits|, with the
bf16 KV caches equal or within one bf16 ulp (after a whole prefill,
one ulp plus fp32's rounding of the terms each entry sums, ``_kv_atol``);
bf16 compute to the
reference's own 0.02 of max|logits| (``tests/test_models_smoke.py``).
The reference attends with ``impl="flash_pallas"`` (the Pallas kernel in
interpret mode), the port with its default, B9's plain version here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import model as jM
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import model as tM
from repro_torch.models import transformer as tT
from repro_torch.train import steps as tsteps

KEY = jax.random.PRNGKey(0)
DENSE = ["qwen3-0.6b", "smollm-135m", "granite-8b", "qwen2.5-14b"]
RECURRENT = ["falcon-mamba-7b", "recurrentgemma-9b"]
UNPORTED = ["dbrx-132b", "llama4-scout-17b-a16e", "seamless-m4t-medium",
            "qwen2-vl-72b"]


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _cfgs(arch, compute_dtype):
    return (dataclasses.replace(jconfigs.get_smoke(arch),
                                compute_dtype=compute_dtype),
            dataclasses.replace(tconfigs.get_smoke(arch),
                                compute_dtype=compute_dtype))


def _params(cfg_j, cfg_t):
    p, _ = jM.init_params(KEY, cfg_j)
    return p, interop.lm_params_from_numpy(
        cfg_t, jax.tree.map(np.asarray, p), device="cpu")


def _within_one_bf16_ulp(a, b, atol=0.0):
    a, b = a.float().numpy(), _np(b)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(
        mag, 1e-38))) - 7), 0.0)
    return bool(np.all(np.abs(a - b) <= ulp + atol))


def _kv_atol(pa, cfg, x_norm):
    """The fp32 part of the band on a bf16 k or v cache entry, for an
    attention layer ``pa`` whose input rows have L2 norms <= ``x_norm``.

    Each side rounds to bf16 (half an ulp of its own magnitude each, one
    ulp together) an fp32 value that lies within (d + 4)·u32·S of the
    exact one: S is the magnitude of the terms summed into the entry, d of
    them in the projection and a few more in the bias, the norm and the
    rope. That second part is order-dependent and bounded by the terms,
    not by the result: an entry that cancels to ~1e-6 from O(1) terms
    can land more than one of its own ulps away (7.6e-7 against 6.8e-7 on
    an AVX-512 CPU). By Cauchy-Schwarz S <= |x|·|W_j| + |b_j| for v and
    for k before the rope; a qk-normed k entry is at most |scale|·sqrt(dh);
    the rope sums two entries. The layer's input itself differs between
    the two sides by a few roundings of its own norm, which the factor 2
    on the two sides' (d + 4) covers."""
    u32, d = 2.0 ** -24, cfg.d_model
    atol = {}
    for n in ("k", "v"):
        w = pa["w" + n]
        s = x_norm * float(w["w"].norm(dim=0).max()) + (
            float(w["b"].abs().max()) if "b" in w else 0.0)
        if n == "k":
            if "qknorm" in pa:
                s = float(pa["qknorm"]["k_scale"].abs().max()) * cfg.dh ** .5
            s *= 2.0
        atol[n] = 2 * (d + 4) * u32 * s
    return atol


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_configs_are_the_reference_literals(arch):
    for getter in ("get", "get_smoke"):
        want = dataclasses.asdict(getattr(jconfigs, getter)(arch))
        got = dataclasses.asdict(getattr(tconfigs, getter)(arch))
        assert got == want
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        pj = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        pt = {"scale": _t(scale), "bias": _t(bias)}
        _close(tL.apply_norm(pt, _t(x), kind), jL.apply_norm(pj, x, kind),
               1e-6)
    _close(tL.apply_head_rmsnorm(_t(x), _t(scale)),
           jL.apply_head_rmsnorm(x, jnp.asarray(scale)), 1e-6)
    pos = rng.integers(0, 3000, (2, 5))
    _close(tL.apply_rope(_t(x), torch.tensor(pos), 1e6),
           jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)
    _close(tL.rope_freqs(16, 1e4), jL.rope_freqs(16, 1e4), 1e-6)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    for act in ("silu", "gelu"):
        pj, _ = jL.mlp_init(KEY, 16, 24, act, jnp.float32)
        pt = jax.tree.map(lambda a: _t(a), pj)
        _close(tL.apply_mlp(pt, _t(h), act, torch.float32),
               jL.apply_mlp(pj, jnp.asarray(h), act, jnp.float32), 1e-5)
    pj, _ = jL.dense_init(KEY, 16, 8, jnp.float32, bias=True)
    pj["b"] = jnp.asarray(rng.standard_normal(8).astype(np.float32))
    pt = jax.tree.map(lambda a: _t(a), pj)
    _close(tL.apply_dense(pt, _t(h, torch.bfloat16), torch.bfloat16),
           jL.apply_dense(pj, jnp.asarray(h).astype(jnp.bfloat16),
                          jnp.bfloat16), 1e-2)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    ids = rng.integers(0, 40, (2, 5))
    _close(tL.apply_embed({"table": _t(table)}, torch.tensor(ids),
                          torch.float32),
           jL.apply_embed({"table": jnp.asarray(table)}, jnp.asarray(ids),
                          jnp.float32), 0.0)
    _close(tL.apply_unembed({"table": _t(table)}, _t(h), torch.float32),
           jL.apply_unembed({"table": jnp.asarray(table)}, jnp.asarray(h),
                            jnp.float32), 1e-5)
    assert tL.dtype_of("bfloat16") == torch.bfloat16
    with pytest.raises(NotImplementedError, match="A18"):
        tL.apply_mrope(_t(x), None, 1e4, (2, 3, 3))


# ---------------------------------------------------------------------------
# attention: forward, decode_step, the prefill cache
# ---------------------------------------------------------------------------

def _attn_params(cfg_j):
    pj, _ = jattn.init(KEY, cfg_j, jnp.float32)
    if cfg_j.qk_norm:    # non-trivial qk-norm scales
        rng = np.random.default_rng(5)
        for n in ("q_scale", "k_scale"):
            pj["qknorm"][n] = jnp.asarray(
                1.0 + 0.2 * rng.standard_normal(cfg_j.dh), jnp.float32)
    return pj, jax.tree.map(lambda a: _t(a), pj)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2.5-14b"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_forward_matches_reference(arch, window):
    cfg_j, cfg_t = _cfgs(arch, "float32")
    pj, pt = _attn_params(cfg_j)
    x = np.random.default_rng(1).standard_normal(
        (2, 11, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    want = jattn.forward(pj, jnp.asarray(x), cfg_j, pos=jnp.asarray(pos),
                         window=window, impl="flash_pallas",
                         compute_dtype=jnp.float32)
    got = tattn.forward(pt, _t(x), cfg_t, pos=torch.tensor(pos),
                        window=window, compute_dtype=torch.float32)
    _close(got, want, 1e-5)
    ref = tattn.forward(pt, _t(x), cfg_t, pos=torch.tensor(pos),
                        window=window, impl="ref",
                        compute_dtype=torch.float32)
    _close(ref, want, 1e-5)


@pytest.mark.parametrize("window,max_len,positions", [
    (None, 12, [7, 8, 9]),
    (4, 12, [7, 8, 9, 10]),       # ring buffer wraps
    (None, 8, [8, 9])])           # past the cache: the write is clamped
def test_decode_step_matches_reference(window, max_len, positions):
    cfg_j, cfg_t = _cfgs("qwen3-0.6b", "float32")
    pj, pt = _attn_params(cfg_j)
    rng = np.random.default_rng(2)
    W = max_len if window is None else min(window, max_len)
    shape = (2, W, cfg_j.n_kv_heads, cfg_j.dh)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    cj = {"k": jnp.asarray(ck, jnp.bfloat16), "v": jnp.asarray(cv,
                                                               jnp.bfloat16)}
    ct = {"k": _t(ck, torch.bfloat16), "v": _t(cv, torch.bfloat16)}
    for pos in positions:
        x = rng.standard_normal((2, 1, cfg_j.d_model)).astype(np.float32)
        oj, cj = jattn.decode_step(pj, cj, jnp.asarray(x), cfg_j,
                                   pos=jnp.int32(pos), window=window,
                                   compute_dtype=jnp.float32)
        ot, ct = tattn.decode_step(pt, ct, _t(x), cfg_t, pos=pos,
                                   window=window,
                                   compute_dtype=torch.float32)
        _close(ot, oj, 1e-5)
        for n in ("k", "v"):
            assert ct[n].dtype == torch.bfloat16
            assert _within_one_bf16_ulp(ct[n], cj[n])


@pytest.mark.parametrize("window,T,max_len", [(None, 6, 10), (4, 10, 12),
                                              (8, 5, 12), (16, 7, 10)])
def test_fill_kv_cache_matches_reference(window, T, max_len):
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    want = jT._fill_kv_cache(jnp.asarray(k, jnp.bfloat16),
                             jnp.asarray(v, jnp.bfloat16), window, max_len)
    got = tT._fill_kv_cache(_t(k, torch.bfloat16), _t(v, torch.bfloat16),
                            window, max_len)
    for n in ("k", "v"):
        assert got[n].dtype == torch.bfloat16
        assert got[n].shape == want[n].shape
        assert np.array_equal(got[n].float().numpy(), _np(want[n]))


def test_unported_attention_impls_raise():
    """flash_xla (the training attention) runs and agrees with ref; an
    unknown impl raises; B9 (flash_pallas) has no backward, so it raises
    when autograd would differentiate it, naming flash_xla."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 2, 16, generator=g)
    got = tattn.attend(q, q, q, impl="flash_xla")
    _close(got, tattn.attend(q, q, q, impl="ref").numpy(), 1e-5)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attend(q, q, q, impl="splash")
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="flash_xla"):
        tattn.attend(qg, q, q, impl="flash_pallas")
    with torch.no_grad():
        tattn.attend(qg, q, q, impl="flash_pallas")


# ---------------------------------------------------------------------------
# the whole serving path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, compute_dtype):
    cfg_j, cfg_t = _cfgs(arch, compute_dtype)
    pj, pt = _params(cfg_j, cfg_t)
    B, T, n_dec = 2, 12, 4
    max_len = T + n_dec
    toks = np.random.default_rng(4).integers(0, cfg_j.vocab,
                                             (B, T + n_dec))
    lj, cj = jM.prefill(pj, {"tokens": jnp.asarray(toks[:, :T])}, cfg_j,
                        max_len=max_len, impl="flash_pallas")
    lt, ct = tM.prefill(pt, {"tokens": torch.tensor(toks[:, :T])}, cfg_t,
                        max_len=max_len)
    pairs = [(lt, lj)]
    for t in range(T, T + n_dec):
        lj, cj = jM.decode(pj, cj, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t), cfg_j)
        lt, ct = tM.decode(pt, ct, torch.tensor(toks[:, t:t + 1]), t, cfg_t)
        pairs.append((lt, lj))
    scale = max(float(np.abs(_np(w)).max()) for _, w in pairs)
    err = max(float(np.abs(g.float().numpy() - _np(w)).max())
              for g, w in pairs)
    assert lt.shape == (B, 1, cfg_t.padded_vocab)
    assert err <= (1e-4 if compute_dtype == "float32" else 0.02) * scale
    if compute_dtype == "float32":
        for layer, c in enumerate(ct):
            # the input is the layer's pre-norm: rows of norm <= |scale|·√d
            lp = pt["stack"]["layers"][layer]
            atol = _kv_atol(lp["attn"], cfg_t, float(
                lp["ln1"]["scale"].abs().max()) * cfg_t.d_model ** 0.5)
            for n in ("k", "v"):
                assert _within_one_bf16_ulp(c[n], cj["scan"]["u0"][n][layer],
                                            atol[n])


@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_decode_consistency(arch):
    """prefill(T0) + decode(T0..S) logits match the port's own full
    forward (the counterpart of the reference's test_decode_consistency,
    same band)."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch),
                              compute_dtype="float32")
    p = tM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    B, S, Tp = 2, 12, 8
    toks = torch.tensor(np.random.default_rng(5).integers(0, cfg.vocab,
                                                          (B, S)))
    full, aux = tM.logits_fn(p, {"tokens": toks}, cfg)
    assert full.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    lg, cache = tM.prefill(p, {"tokens": toks[:, :Tp]}, cfg, max_len=S)
    errs = [float((lg[:, 0] - full[:, Tp - 1]).abs().max())]
    for t in range(Tp, S - 1):
        lg, cache = tM.decode(p, cache, toks[:, t:t + 1], t, cfg)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    scale = float(full.abs().max()) + 1e-6
    assert max(errs) / scale < 0.02, (max(errs), scale)
    ref, _ = tM.logits_fn(p, {"tokens": toks}, cfg, impl="ref")
    assert float((ref - full).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_shapes_match_reference(arch):
    cfg_t = tconfigs.get_smoke(arch)
    shapes, _ = jM.param_shapes(jconfigs.get_smoke(arch))
    _, reps, _ = cfg_t.layer_pattern()
    p = tM.init_params(cfg_t, generator=torch.Generator().manual_seed(1),
                       device="cpu")
    want = {}
    for path, sds in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[:3] == ["stack", "scan", "u0"]:
            for r in range(reps):
                name = ".".join(["stack", "layers", str(r)] + keys[3:])
                want[name] = (tuple(sds.shape[1:]), str(sds.dtype))
        else:
            want[".".join(map(str, keys))] = (tuple(sds.shape),
                                              str(sds.dtype))
    got = {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in p.named_parameters()}
    assert got == want
    assert not any(t.requires_grad for t in p.parameters())
    # the reference's distributions: ones for norm scales, in_dim^-0.5
    # normals for projections, d^-0.5 for the embedding
    assert torch.equal(p["final_norm"]["scale"],
                       torch.ones(cfg_t.d_model))
    wq = p["stack"]["layers"][0]["attn"]["wq"]["w"]
    assert abs(float(wq.std()) * cfg_t.d_model ** 0.5 - 1.0) < 0.1
    emb = p["embed"]["table"]
    assert abs(float(emb.std()) * cfg_t.d_model ** 0.5 - 1.0) < 0.05
    # the cache layout: one (B, max_len, KV, dh) bf16 pair per layer
    cache = tM.cache_shapes(cfg_t, 3, 20)
    jc, _ = jM.cache_shapes(jconfigs.get_smoke(arch), 3, 20)
    assert len(cache) == reps
    zero = tattn.init_cache(cfg_t, 3, 20, window=8, device="cpu")
    assert zero["k"].shape == (3, 8, cfg_t.n_kv_heads, cfg_t.dh)
    assert not zero["v"].any() and zero["v"].dtype == torch.bfloat16
    for c in cache:
        for n in ("k", "v"):
            assert c[n].shape == jc["scan"]["u0"][n].shape[1:]
            assert c[n].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise_with_roadmap_item(arch):
    cfg = tconfigs.get_smoke(arch)
    with pytest.raises(NotImplementedError, match="A18"):
        tM.init_params(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="A18"):
        tM.cache_shapes(cfg, 1, 8)
    with pytest.raises(NotImplementedError, match="A18"):
        interop.lm_params_from_numpy(cfg, {}, device="cpu")


def test_training_entry_points_raise_with_roadmap_item():
    """Training runs (loss_fn, make_train_step); the sharded step
    (launch/train --mesh) raises, naming A17's third part."""
    from repro_torch.launch import train as ttrain
    cfg = tconfigs.get_smoke("qwen3-0.6b")
    p = tM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu", trainable=True)
    toks = torch.randint(0, cfg.vocab, (1, 8),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    loss, mets = tM.loss_fn(p, batch, cfg)
    assert torch.isfinite(loss) and set(mets) == {"nll", "aux",
                                                  "ppl_proxy"}
    state = tsteps.TrainState.create(p, use_ef=False)
    _, mets = tsteps.make_train_step(cfg, tsteps.TrainConfig())(state, batch)
    assert torch.isfinite(mets["loss"])
    with pytest.raises(NotImplementedError, match="A17, third part"):
        ttrain.main(["--arch", "qwen3-0.6b", "--mesh", "2x4",
                     "--device", "cpu"])


def test_serve_entry_point_on_the_cpu(capsys):
    assert tserve.main(["--arch", "qwen3-0.6b", "--prompt-len", "9",
                        "--gen", "3", "--batch", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[serve]") == 3 and "tok/s" in out
    cfg = tconfigs.get_smoke("smollm-135m")
    p = tM.init_params(cfg, generator=torch.Generator().manual_seed(2),
                       device="cpu")
    toks = torch.as_tensor(tserve.make_prompts(cfg, 2, 10, seed=7))
    assert toks.shape == (2, 10) and int(toks.max()) < cfg.vocab
    res = tserve.serve(p, cfg, toks, gen=4, max_len=14)
    again = tserve.serve(p, cfg, toks, gen=4, max_len=14)
    assert res["tokens"].shape == (2, 4) and res["finite"]
    assert torch.equal(res["tokens"], again["tokens"])     # greedy
    # the greedy token after the prompt is the argmax of the full forward
    full, _ = tM.logits_fn(p, {"tokens": toks}, cfg)
    assert torch.equal(tsteps.greedy_sample(full),
                       tsteps.greedy_sample(res["prefill_logits"]))
    gen = torch.Generator().manual_seed(3)
    drawn = tserve.serve(p, cfg, toks, gen=4, max_len=14, temperature=0.7,
                         generator=gen)["tokens"]
    assert drawn.shape == (2, 4) and int(drawn.max()) < cfg.padded_vocab


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = tconfigs.get_smoke("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tM.init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "qwen3-0.6b"])


# ---------------------------------------------------------------------------
# the recurrent families: falcon-mamba (ssm) and recurrentgemma (hybrid)
# ---------------------------------------------------------------------------

def _stacked_layers(cfg, tree):
    """The reference's stacked layer trees taken apart in stack order:
    for each repeat the unit's positions, then the tail."""
    unit, reps, tail = cfg.layer_pattern()
    return [jax.tree.map(lambda a, r=r: a[r], tree["stack"]["scan"][f"u{i}"])
            for r in range(reps) for i in range(len(unit))] + \
        list(tree["stack"]["tail"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,T", [("falcon-mamba-7b", 70),
                                    ("recurrentgemma-9b", 40)])
def test_recurrent_prefill_and_decode_match_reference(arch, T,
                                                      compute_dtype):
    """prefill + 4 decode steps against the reference. falcon-mamba at
    T = 70 runs two scan chunks and the pad; recurrentgemma at T = 40,
    past its window of 16, wraps the ring cache and B9's window. fp32
    logits, and each layer's carried state h, within the whole model's
    1e-4 of their largest magnitude (a deep layer's state carries the
    layers' rounding above it), the bf16 conv history within one bf16 ulp
    of its largest entry (a near-zero entry of a deep layer may round to
    another bf16 value); bf16 within the reference's 0.02."""
    cfg_j, cfg_t = _cfgs(arch, compute_dtype)
    pj, pt = _params(cfg_j, cfg_t)
    B, n_dec = 2, 4
    max_len = T + n_dec
    toks = np.random.default_rng(6).integers(0, cfg_j.vocab, (B, T + n_dec))
    lj, cj = jM.prefill(pj, {"tokens": jnp.asarray(toks[:, :T])}, cfg_j,
                        max_len=max_len, impl="flash_pallas")
    lt, ct = tM.prefill(pt, {"tokens": torch.tensor(toks[:, :T])}, cfg_t,
                        max_len=max_len)
    pairs = [(lt, lj)]
    for t in range(T, T + n_dec):
        lj, cj = jM.decode(pj, cj, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t), cfg_j)
        lt, ct = tM.decode(pt, ct, torch.tensor(toks[:, t:t + 1]), t, cfg_t)
        pairs.append((lt, lj))
    scale = max(float(np.abs(_np(w)).max()) for _, w in pairs)
    err = max(float(np.abs(g.float().numpy() - _np(w)).max())
              for g, w in pairs)
    assert lt.shape == (B, 1, cfg_t.padded_vocab)
    assert err <= (1e-4 if compute_dtype == "float32" else 0.02) * scale
    kinds = tT.layer_kinds(cfg_t)
    assert len(ct) == len(kinds) == cfg_t.n_layers
    for c, want, kind in zip(ct, _stacked_layers(cfg_j, {"stack": cj}),
                             kinds):
        if kind == "attn":
            assert set(c) == {"k", "v"}
            assert c["k"].shape == (B, cfg_t.rglru.window, cfg_t.n_kv_heads,
                                    cfg_t.dh)
            continue
        assert set(c) == {"h", "conv"}
        assert c["h"].dtype == torch.float32
        assert c["conv"].dtype == torch.bfloat16
        assert c["h"].shape == want["h"].shape
        if compute_dtype == "float32":
            h = _np(want["h"])
            assert float(np.abs(c["h"].numpy() - h).max()) <= \
                1e-4 * float(np.abs(h).max())
            conv = _np(want["conv"])
            top = float(np.abs(conv).max())
            assert float(np.abs(c["conv"].float().numpy() - conv).max()) \
                <= 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("kind,T", [("ssm", 2), ("ssm", 9), ("rec", 2),
                                    ("rec", 9)])
def test_recurrent_layer_prefill_caches_match_reference(kind, T):
    """apply_layer_prefill's output and its {"h", "conv"} cache for one
    ssm or rec layer; T = 2 < conv - 1 takes _tail_pad's left pad."""
    arch = "falcon-mamba-7b" if kind == "ssm" else "recurrentgemma-9b"
    cfg_j, cfg_t = _cfgs(arch, "float32")
    pj, _ = jT.init_layer(KEY, kind, cfg_j, jnp.float32)
    pt = jax.tree.map(lambda a: _t(a), pj)
    x = np.random.default_rng(8).standard_normal(
        (2, T, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (2, T))
    yj, cj = jT.apply_layer_prefill(pj, jnp.asarray(x), kind, cfg_j,
                                    pos=jnp.asarray(pos), max_len=T + 4,
                                    compute_dtype=jnp.float32)
    yt, ct = tT.apply_layer_prefill(pt, _t(x), kind, cfg_t,
                                    pos=torch.tensor(pos), max_len=T + 4,
                                    compute_dtype=torch.float32)
    _close(yt, yj, 1e-5)
    _close(ct["h"], cj["h"], 1e-5)
    assert ct["conv"].shape == cj["conv"].shape == (
        2, 3, cj["conv"].shape[-1])
    assert _within_one_bf16_ulp(ct["conv"], cj["conv"])
    if T < 3:                       # left-padded with zeros
        assert not ct["conv"][:, :3 - T].any()
    # the cache owns its storage: no view of the layer's activations
    assert ct["conv"].untyped_storage().nbytes() == \
        ct["conv"].numel() * ct["conv"].element_size()
    yd, _ = tT.apply_layer(pt, _t(x), kind, cfg_t, pos=torch.tensor(pos),
                           compute_dtype=torch.float32)
    assert torch.allclose(yd, yt, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_params_from_numpy_on_the_unit_shapes(arch):
    """lm_params_from_numpy un-stacks the full configs' unit shapes:
    recurrentgemma's (rec, rec, attn) x 12 with the (rec, rec) tail, and
    falcon-mamba's (ssm,) x 64 (at narrow widths): each port layer holds
    the reference's layer of the same index, bit for bit, and the port's
    own init_params gives the same names and shapes."""
    full = jconfigs.get(arch)
    narrow = dict(d_model=32, vocab=300, d_ff=48)
    if arch == "recurrentgemma-9b":
        narrow.update(n_heads=2, n_kv_heads=1)
    cfg_j = dataclasses.replace(full, **narrow)
    cfg_t = dataclasses.replace(tconfigs.get(arch), **narrow)
    unit, reps, tail = cfg_t.layer_pattern()
    assert (unit, reps, tail) == ((("ssm",), 64, ()) if arch.startswith(
        "falcon") else (("rec", "rec", "attn"), 12, ("rec", "rec")))
    pj, _ = jM.init_params(KEY, cfg_j)
    tree = jax.tree.map(np.asarray, pj)
    pt = interop.lm_params_from_numpy(cfg_t, tree, device="cpu")
    want = _stacked_layers(cfg_j, tree)
    assert len(pt["stack"]["layers"]) == len(want) == cfg_t.n_layers
    for layer, w in zip(pt["stack"]["layers"], want):
        got = {n: t.detach().numpy() for n, t in layer.named_parameters()}
        flat = {".".join(str(getattr(k, "key", k)) for k in path): a
                for path, a in jax.tree_util.tree_flatten_with_path(w)[0]}
        assert got.keys() == flat.keys()
        assert all(np.array_equal(got[n], flat[n]) for n in flat)
    mine = tM.init_params(cfg_t, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert {n: tuple(t.shape) for n, t in mine.named_parameters()} == \
        {n: tuple(t.shape) for n, t in pt.named_parameters()}
    assert not any(t.requires_grad for t in mine.parameters())
    cache = tM.cache_shapes(cfg_t, 3, 20)
    jc, _ = jM.cache_shapes(cfg_j, 3, 20)
    for c, w in zip(cache, _stacked_layers(
            cfg_j, {"stack": jax.tree.map(lambda s: np.zeros(s.shape),
                                          jc["stack"] if "stack" in jc
                                          else jc)})):
        assert {n: tuple(t.shape) for n, t in c.items()} == \
            {n: tuple(a.shape) for n, a in w.items()}


def test_recurrent_training_raises_with_roadmap_item():
    """The ssm and hybrid families train (their train step builds and
    launch/train runs a step); the train step and launch/train of the
    families the port does not build (moe, encdec, vlm) raise, naming
    the A18 item, before any weight is drawn."""
    from repro_torch.launch import train as ttrain
    for arch in RECURRENT:
        cfg = tconfigs.get_smoke(arch)
        assert callable(tsteps.make_train_step(cfg, tsteps.TrainConfig()))
        assert ttrain.main(["--arch", arch, "--steps", "1", "--seq-len",
                            "8", "--global-batch", "1",
                            "--device", "cpu"]) == 0
    for arch in UNPORTED:
        cfg = tconfigs.get_smoke(arch)
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP A18 \(the port builds the dense"):
            tsteps.make_train_step(cfg, tsteps.TrainConfig())
        with pytest.raises(NotImplementedError, match="A18"):
            ttrain.main(["--arch", arch, "--steps", "1", "--device", "cpu"])


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_serve_entry_point_on_the_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--prompt-len", "20", "--gen", "3",
                        "--batch", "2", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("[serve]") == 3
    cfg = tconfigs.get_smoke(arch)
    p = tM.init_params(cfg, generator=torch.Generator().manual_seed(2),
                       device="cpu")
    toks = torch.as_tensor(tserve.make_prompts(cfg, 2, 20, seed=7))
    res = tserve.serve(p, cfg, toks, gen=4, max_len=24)
    assert res["tokens"].shape == (2, 4) and res["finite"]
    full, _ = tM.logits_fn(p, {"tokens": toks}, cfg)
    assert torch.equal(tsteps.greedy_sample(full),
                       tsteps.greedy_sample(res["prefill_logits"]))
