"""repro_torch.models.mamba (falcon-mamba's selective scan) and the shared
log-depth scan (layers.affine_scan) against the JAX reference: forwards,
and the backwards (affine_scan's reverse scan against ``jax.grad`` of
``associative_scan``; the chunked scan's hand-written backward against
``jax.vjp`` of the reference's custom VJP, and the bytes it saves).

Weights come from the reference's ``mamba.init`` on the smoke config
(d_model 64, d_inner 128, state 4); inputs are drawn with numpy from a
seed and handed to both packages. Every comparison is fp32 and holds the
port's band: 1e-5 of the reference's largest magnitude (the two differ
by the order of fp32 sums and products: the scans' trees, the folded
initial state, matmul blocking).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba as jmamba
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tL
from repro_torch.models import mamba as tmamba

KEY = jax.random.PRNGKey(0)
TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _err(got, want) -> float:
    """max|got - want| / max|want|."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cfgs():
    return (jconfigs.get_smoke("falcon-mamba-7b"),
            tconfigs.get_smoke("falcon-mamba-7b"))


def _params(cfg_j):
    pj, _ = jmamba.init(KEY, cfg_j, jnp.float32)
    # a non-trivial conv bias, dt bias and D, so each term is exercised
    rng = np.random.default_rng(9)
    di = jmamba.d_inner(cfg_j)
    pj["conv"]["b"] = jnp.asarray(0.1 * rng.standard_normal(di), jnp.float32)
    pj["D"] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(di), jnp.float32)
    return pj, jax.tree.map(_t, pj)


def _op(l, r):
    al, bl = l
    ar, br = r
    return al * ar, ar * bl + br


def test_widths_and_init_match_reference():
    cfg_j, cfg_t = _cfgs()
    assert tmamba.d_inner(cfg_t) == jmamba.d_inner(cfg_j) == 128
    assert tmamba.dt_rank(cfg_t) == jmamba.dt_rank(cfg_j) == 4
    pj, _ = jmamba.init(KEY, cfg_j, jnp.float32)
    pt = tmamba.init(torch.Generator().manual_seed(0), cfg_t, torch.float32)
    shapes = jax.tree.map(lambda a: tuple(a.shape), pj)
    assert jax.tree.map(lambda a: tuple(a.shape), pt) == shapes
    # the deterministic leaves are the reference's
    for name in ("A_log", "D"):
        assert _err(pt[name], pj[name]) <= 1e-7
    assert _err(pt["dt_proj"]["b"], pj["dt_proj"]["b"]) <= 1e-6


def test_ssm_params_match_reference():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j)
    xb = np.random.default_rng(0).standard_normal(
        (2, 10, jmamba.d_inner(cfg_j))).astype(np.float32)
    want = jmamba._ssm_params(pj, jnp.asarray(xb), cfg_j)
    got = tmamba._ssm_params(pt, _t(xb), cfg_t)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _err(g, w) <= TOL


@pytest.mark.parametrize("T", [1, 2, 7, 64, 100, 4096])
def test_affine_scan_matches_associative_scan(T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.05, 1.0, (T, 3, 4)).astype(np.float32)
    b = rng.standard_normal((T, 3, 4)).astype(np.float32)
    _, want = jax.lax.associative_scan(_op, (jnp.asarray(a), jnp.asarray(b)),
                                       axis=0)
    assert _err(tL.affine_scan(_t(a), _t(b)), want) <= TOL


def test_affine_scan_underflow_stays_exact():
    """Decays whose products underflow: no division, no NaN."""
    h = tL.affine_scan(torch.full((200, 2), 0.5), torch.ones(200, 2))
    assert bool(torch.isfinite(h).all())
    assert torch.equal(h[-1], torch.full((2,), 2.0))


def _gerr(got, want) -> float:
    """max|got - want| / max|want|, 0 where both are 0 (T = 1's da)."""
    want = np.asarray(want, np.float32)
    d = float(np.abs(got.detach().numpy() - want).max())
    return d / max(float(np.abs(want).max()), 1e-30) if d else 0.0


@pytest.mark.parametrize("T", [1, 7, 64, 100])
def test_affine_scan_grads_match_jax_grad(T):
    """affine_scan's backward (the reverse scan from the saved a and h)
    against jax.grad of associative_scan with the reference's combine,
    for a cotangent on every state."""
    rng = np.random.default_rng(T + 50)
    a = rng.uniform(0.05, 1.0, (T, 3, 4)).astype(np.float32)
    b, g = (rng.standard_normal((T, 3, 4)).astype(np.float32)
            for _ in range(2))

    def f(a, b):
        _, h = jax.lax.associative_scan(_op, (a, b), axis=0)
        return jnp.sum(h * jnp.asarray(g))
    wa, wb = jax.grad(f, (0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = (_t(v).requires_grad_() for v in (a, b))
    ga, gb = torch.autograd.grad((tL.affine_scan(at, bt) * _t(g)).sum(),
                                 (at, bt))
    assert _gerr(ga, wa) <= TOL and _gerr(gb, wb) <= TOL
    if T == 1:
        assert not bool(ga.any())          # h_{-1} = 0


def test_affine_scan_gradcheck_fp64():
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.uniform(0.05, 1.0, (13, 2, 3)),
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal((13, 2, 3)), requires_grad=True)
    assert torch.autograd.gradcheck(tL.affine_scan, (a, b))


def test_affine_scan_grads_underflow_stay_exact():
    """Decays whose products underflow: the reverse scan divides by
    nothing either, so the backward stays finite and exact: with a = 0.5
    and a cotangent of 1 on every state, r_t = 1 + 0.5 r_{t+1} reaches
    2 exactly; with a = 1e-30 every product past two steps is 0."""
    a = torch.full((200, 2), 0.5, requires_grad=True)
    b = torch.ones(200, 2, requires_grad=True)
    ga, gb = torch.autograd.grad(tL.affine_scan(a, b).sum(), (a, b))
    assert torch.equal(gb[0], torch.full((2,), 2.0))
    assert torch.equal(ga[-1], torch.full((2,), 2.0))   # r h_{-2} = 1 x 2
    tiny = torch.full((200, 2), 1e-30, requires_grad=True)
    ga, gb = torch.autograd.grad(tL.affine_scan(tiny, b).sum(), (tiny, b))
    assert bool(torch.isfinite(ga).all()) and bool(torch.isfinite(gb).all())
    assert torch.equal(gb, torch.ones_like(gb)) and torch.equal(
        ga[1:], torch.ones_like(ga[1:]))


def _ssm_inputs(T, B=2, di=8, N=4):
    rng = np.random.default_rng(T)
    d = rng.uniform(0.001, 0.2, (B, T, di)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, N)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((B, T, di)).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    dy = rng.standard_normal((B, T, di)).astype(np.float32)
    dh = rng.standard_normal((B, di, N)).astype(np.float32)
    return (d, Bm, Cm, x, A, h0), (dy, dh)


@pytest.mark.parametrize("T", [40, 64, 128])
def test_chunked_ssm_vjp_matches_reference(T):
    """The hand-written backward against jax.vjp of the reference's
    custom VJP, with cotangents on y and on h_last and a nonzero h0: T =
    40 one short chunk, 64 one chunk, 128 two (the carry between them)."""
    ins, (dy, dh) = _ssm_inputs(T)
    (wy, wh), vjp = jax.vjp(jmamba._chunked_ssm,
                            *(jnp.asarray(v) for v in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    ts = [_t(v).requires_grad_() for v in ins]
    y, h = tmamba._chunked_ssm(*ts)
    assert _err(y, wy) <= TOL and _err(h, wh) <= TOL
    got = torch.autograd.grad((y, h), ts, (_t(dy), _t(dh)))
    for name, g, w in zip(("delta", "B", "C", "x", "A", "h0"), got, want):
        assert g.dtype == torch.float32
        assert _gerr(g, w) <= TOL, name


def test_chunked_ssm_saves_only_inputs_and_chunk_states():
    """What autograd keeps for the backward, counted by
    saved_tensors_hooks: the inputs plus each chunk's incoming state
    (n_chunks, B, di, N) fp32, nothing else. Autograd through the same
    forward (the chunk loop with the differentiable affine_scan) keeps
    every round of every chunk, several times that."""
    T, B, di, N = 256, 2, 8, 4
    ins, (dy, dh) = _ssm_inputs(T, B, di, N)

    def saved_bytes(fn):
        seen = []

        def pack(t):
            seen.append(t.numel() * t.element_size())
            return t
        ts = [_t(v).requires_grad_() for v in ins]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, h = fn(*ts)
        torch.autograd.grad((y, h), ts, (_t(dy), _t(dh)))
        return sum(seen)
    inputs = sum(v.nbytes for v in ins)
    states = (T // 64) * B * di * N * 4
    assert saved_bytes(tmamba._chunked_ssm) <= inputs + states
    assert saved_bytes(tmamba._ssm_forward) > 4 * (inputs + states)


@pytest.mark.parametrize("Lc", [1, 5, 64])
def test_chunk_scan_matches_reference(Lc):
    rng = np.random.default_rng(Lc)
    a = rng.uniform(0.3, 1.0, (2, Lc, 6, 4)).astype(np.float32)
    bx = rng.standard_normal((2, Lc, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    wh, wl = jmamba._chunk_scan(jnp.asarray(a), jnp.asarray(bx),
                                jnp.asarray(h0))
    # the port's chunk is time-major: (Lc, B, di, N)
    gh, gl = tmamba._chunk_scan(_t(a).transpose(0, 1), _t(bx).transpose(0, 1),
                                _t(h0))
    assert _err(gh.transpose(0, 1), wh) <= TOL and _err(gl, wl) <= TOL


def test_chunk_fwd_matches_reference():
    cfg_j, _ = _cfgs()
    rng = np.random.default_rng(3)
    B, Lc, di, N = 2, 16, 8, 4
    d = rng.uniform(0.001, 0.2, (B, Lc, di)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, Lc, N)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((B, Lc, di)).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    h = rng.standard_normal((B, di, N)).astype(np.float32)
    wy, wh, wl, wa = jmamba._chunk_fwd(*(jnp.asarray(v) for v in
                                         (A, h, d, Bm, Cm, x)))
    gy, gh, gl, ga = tmamba._chunk_fwd(*(_t(v) for v in (A, h, d, Bm, Cm,
                                                         x)))
    assert _err(gy, wy) <= TOL and _err(gl, wl) <= TOL
    # the port keeps the chunk's states and decays time-major
    assert _err(gh.transpose(0, 1), wh) <= TOL
    assert _err(ga.transpose(0, 1), wa) <= TOL


@pytest.mark.parametrize("T", [50, 100, 128])
def test_scan_sequence_matches_reference(T):
    """T = 50: one short chunk; 100: two chunks and the pad to 128; 128:
    two whole chunks."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j)
    rng = np.random.default_rng(T)
    di, N = jmamba.d_inner(cfg_j), cfg_j.ssm.state
    xb = (0.5 * rng.standard_normal((2, T, di))).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((2, di, N))).astype(np.float32)
    wy, wh = jmamba.scan_sequence(pj, jnp.asarray(xb), cfg_j,
                                  jnp.asarray(h0))
    gy, gh = tmamba.scan_sequence(pt, _t(xb), cfg_t, _t(h0))
    assert gy.shape == (2, T, di) and gh.shape == (2, di, N)
    assert _err(gy, wy) <= TOL and _err(gh, wh) <= TOL


def test_forward_and_decode_match_reference():
    """The block's forward, then five decode steps from its carried state
    against the reference's."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j)
    rng = np.random.default_rng(7)
    x = (0.5 * rng.standard_normal((2, 12, cfg_j.d_model))).astype(
        np.float32)
    want = jmamba.forward(pj, jnp.asarray(x), cfg_j, jnp.float32)
    got = tmamba.forward(pt, _t(x), cfg_t, torch.float32)
    assert _err(got, want) <= TOL
    sj, _ = jmamba.init_state(cfg_j, 2)
    st = tmamba.init_state(cfg_t, 2)
    assert all(st[n].shape == sj[n].shape and st[n].dtype == torch.float32
               for n in sj)
    sj = {"h": jnp.asarray(rng.standard_normal(sj["h"].shape), jnp.float32),
          "conv": jnp.asarray(rng.standard_normal(sj["conv"].shape),
                              jnp.float32)}
    st = {n: _t(v) for n, v in sj.items()}
    for _ in range(5):
        xt = (0.5 * rng.standard_normal((2, 1, cfg_j.d_model))).astype(
            np.float32)
        oj, sj = jmamba.decode_step(pj, sj, jnp.asarray(xt), cfg_j,
                                    jnp.float32)
        ot, st = tmamba.decode_step(pt, st, _t(xt), cfg_t, torch.float32)
        assert ot.shape == (2, 1, cfg_j.d_model)
        assert _err(ot, oj) <= TOL
        for n in ("h", "conv"):
            assert _err(st[n], sj[n]) <= TOL


def test_decode_steps_equal_the_scan():
    """Stepping the decode recurrence over a sequence gives the chunked
    forward's outputs (the reference's test_scan_matches_stepwise, at the
    port's fp32 band rather than 1e-3)."""
    _, cfg_t = _cfgs()
    cfg_t = dataclasses.replace(cfg_t, compute_dtype="float32")
    pt = tmamba.init(torch.Generator().manual_seed(4), cfg_t, torch.float32)
    x = 0.5 * torch.randn(2, 70, cfg_t.d_model,
                          generator=torch.Generator().manual_seed(5))
    full = tmamba.forward(pt, x, cfg_t, torch.float32)
    st = tmamba.init_state(cfg_t, 2)
    outs = []
    for t in range(70):
        o, st = tmamba.decode_step(pt, st, x[:, t:t + 1], cfg_t,
                                   torch.float32)
        outs.append(o)
    assert _err(torch.cat(outs, 1), full.numpy()) <= TOL
    assert tmamba.state_shape(cfg_t, 3)["conv"].dtype == torch.bfloat16
