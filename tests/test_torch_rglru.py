"""repro_torch.models.rglru (recurrentgemma's RG-LRU block) against the
JAX reference.

Weights come from the reference's ``rglru.init`` on the smoke config
(d_model = lru width 64, conv 4); inputs are drawn with numpy from a seed
and handed to both packages. Every comparison is fp32 and holds the
port's band: 1e-5 of the reference's largest magnitude (the sequence scan
runs another tree of fp32 products than ``associative_scan``; matmuls
block differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro_torch import configs as tconfigs
from repro_torch.models import rglru as trglru

KEY = jax.random.PRNGKey(0)
TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _setup():
    cfg_j = jconfigs.get_smoke("recurrentgemma-9b")
    cfg_t = tconfigs.get_smoke("recurrentgemma-9b")
    pj, _ = jrglru.init(KEY, cfg_j, jnp.float32)
    rng = np.random.default_rng(11)
    w = jrglru.width(cfg_j)
    for name in ("gate_a", "gate_x", "conv"):    # non-zero biases
        pj[name]["b"] = jnp.asarray(0.2 * rng.standard_normal(w),
                                    jnp.float32)
    return cfg_j, cfg_t, pj, jax.tree.map(_t, pj)


def test_width_and_init_match_reference():
    cfg_j, cfg_t, pj, _ = _setup()
    assert trglru.width(cfg_t) == jrglru.width(cfg_j) == 64
    pt = trglru.init(torch.Generator().manual_seed(0), cfg_t, torch.float32)
    assert jax.tree.map(lambda a: tuple(a.shape), pt) == \
        jax.tree.map(lambda a: tuple(a.shape), pj)
    want, _ = jrglru.init(KEY, cfg_j, jnp.float32)
    assert _err(pt["lam"], want["lam"]) <= 1e-5


def test_lru_coeffs_match_reference():
    cfg_j, _, pj, pt = _setup()
    xc = np.random.default_rng(0).standard_normal(
        (2, 16, jrglru.width(cfg_j))).astype(np.float32)
    wa, wb = jrglru._lru_coeffs(pj, jnp.asarray(xc))
    ga, gb = trglru._lru_coeffs(pt, _t(xc))
    assert _err(ga, wa) <= TOL and _err(gb, wb) <= TOL
    assert 0.0 < float(ga.min()) and float(ga.max()) < 1.0


def test_forward_matches_reference():
    cfg_j, cfg_t, pj, pt = _setup()
    x = np.random.default_rng(1).standard_normal(
        (2, 37, cfg_j.d_model)).astype(np.float32)
    want = jrglru.forward(pj, jnp.asarray(x), cfg_j, jnp.float32)
    got = trglru.forward(pt, _t(x), cfg_t, torch.float32)
    assert got.shape == want.shape
    assert _err(got, want) <= TOL


def test_scan_matches_associative_scan():
    """The sequence's states h (B, T, w) against the reference's
    associative_scan over the same coefficients."""
    cfg_j, _, pj, pt = _setup()
    xc = np.random.default_rng(2).standard_normal(
        (2, 300, jrglru.width(cfg_j))).astype(np.float32)
    a, b = jrglru._lru_coeffs(pj, jnp.asarray(xc))

    def op(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    _, want = jax.lax.associative_scan(op, (a, b), axis=1)
    got = trglru.scan(pt, _t(xc))
    assert got.shape == want.shape
    assert _err(got, want) <= TOL


def test_decode_step_matches_reference():
    cfg_j, cfg_t, pj, pt = _setup()
    rng = np.random.default_rng(3)
    sj, _ = jrglru.init_state(cfg_j, 2)
    st = trglru.init_state(cfg_t, 2)
    assert all(st[n].shape == sj[n].shape for n in sj)
    assert st["h"].dtype == torch.float32
    assert st["conv"].dtype == torch.bfloat16
    sj = {"h": jnp.asarray(rng.standard_normal(sj["h"].shape), jnp.float32),
          "conv": jnp.asarray(rng.standard_normal(sj["conv"].shape),
                              jnp.float32)}
    st = {n: _t(v) for n, v in sj.items()}
    for _ in range(5):
        x = rng.standard_normal((2, 1, cfg_j.d_model)).astype(np.float32)
        oj, sj = jrglru.decode_step(pj, sj, jnp.asarray(x), cfg_j,
                                    jnp.float32)
        ot, st = trglru.decode_step(pt, st, _t(x), cfg_t, torch.float32)
        assert _err(ot, oj) <= TOL
        for n in ("h", "conv"):
            assert _err(st[n], sj[n]) <= TOL


def test_state_bounded_under_zero_input():
    """h_{t+1} = a h_t with a < 1: the state decays, never explodes (the
    reference's unit test)."""
    _, cfg_t, _, pt = _setup()
    st = trglru.init_state(cfg_t, 2)
    st["h"] = torch.full_like(st["h"], 10.0)
    x = torch.zeros(2, 1, cfg_t.d_model)
    for _ in range(5):
        _, st = trglru.decode_step(pt, st, x, cfg_t, torch.float32)
    assert float(st["h"].abs().max()) <= 10.0


def test_forward_grads_match_reference():
    """rglru.forward's gradients (the gates' through autograd, the scan's
    through affine_scan's reverse scan) against jax.vjp of the
    reference's forward, for the input and every parameter: 1e-5 of each
    gradient's largest."""
    cfg_j, cfg_t, pj, pt = _setup()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 37, cfg_j.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, 37, cfg_j.d_model)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: jrglru.forward(p, x, cfg_j, jnp.float32),
                     pj, jnp.asarray(x))
    wp, wx = vjp(jnp.asarray(ct))
    ps = jax.tree.map(lambda t: t.requires_grad_(), pt)
    xt = _t(x).requires_grad_()
    out = trglru.forward(ps, xt, cfg_t, torch.float32)
    flat_p, tree = jax.tree.flatten(ps)
    got = torch.autograd.grad(out, [xt, *flat_p], _t(ct))
    assert _err(got[0], wx) <= TOL
    for g, w in zip(got[1:], jax.tree.leaves(wp), strict=True):
        assert _err(g, w) <= TOL
