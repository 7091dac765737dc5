"""The training attention (flash_xla) against the JAX reference: the plain
versions of F (forward with its softmax statistics) and N1 (the backward)
against ``repro.models.attention._blocked_flash_fwd``'s residuals and
``jax.vjp`` of ``_blocked_flash``, on inputs drawn with numpy from a seed.

Bands: fp32 within 1e-5 × max(1, max|ref|) for out, dq, dk and dv and
1e-5 relative for m and l in both dtypes (the two frameworks sum the
dots and the block sums in other orders); bf16 inputs (fp32 arithmetic
inside, the results rounded to bf16) within 1e-2 × max(1, max|ref|),
two bf16 ulps of the largest entry, since one flipped rounding of out
moves D and so every ds of its row. A float64 ``gradcheck`` of the custom op holds the
backward to the forward's finite differences on the plain path. On
CUDA tensors the same functions launch F, N1-dq and N1-dkdv
(``chip_smoke.py`` phase 2e and ``tests/test_torch_cuda.py`` hold them
to these plain versions on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.kernels import flash_attn as tfa
from repro_torch.models import attention as TA

FP32_TOL = 1e-5
BF16_TOL = 1e-2


def _arrays(B, T, S, H, KV, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, H, dh), (B, S, KV, dh), (B, S, KV, dh),
                               (B, T, H, dh)))


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def _rel(got, want, tol):
    want = np.asarray(want, np.float64)
    err = np.abs(got.double().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err


# (B, T, S, H, KV, dh, causal, window, q_offset, bk): GQA groups 1, 2 and 4;
# bk = 16 with S % 16 != 0 walks a padded last block; q_offset > 0 with
# T < S places the queries at the end of a longer history
CASES = [
    (2, 40, 40, 4, 2, 16, True, None, 0, 16),
    (2, 40, 40, 4, 2, 16, True, 8, 0, 16),
    (2, 40, 40, 4, 4, 32, False, None, 0, 16),
    (1, 24, 50, 4, 1, 16, True, None, 26, 16),
    (1, 24, 50, 4, 1, 16, True, 12, 26, 16),
    (1, 24, 50, 4, 2, 16, False, 20, 10, 16),
    (2, 64, 64, 2, 2, 32, True, None, 0, 512),
]
DTYPES = [("float32", FP32_TOL), ("bfloat16", BF16_TOL)]


def _ids(case):
    B, T, S, H, KV, dh, causal, window, q_offset, bk = case
    return (f"T{T}-S{S}-G{H // KV}-d{dh}-{'c' if causal else 'nc'}"
            f"-w{window}-o{q_offset}-bk{bk}")


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=[d for d, _ in DTYPES])
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_forward_and_statistics_match_reference(case, dtype, tol):
    B, T, S, H, KV, dh, causal, window, q_offset, bk = case
    q, k, v, _ = _arrays(B, T, S, H, KV, dh, seed=T + S)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    bk = min(bk, S)
    out_r, (_, _, _, _, m_r, l_r) = JA._blocked_flash_fwd(
        jq, jk, jv, causal, window, q_offset, bk)
    out, m, l = tfa.flash_attention_train(
        *(torch.tensor(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window, q_offset=q_offset, bk=bk)
    assert out.dtype == tdt and m.dtype == l.dtype == torch.float32
    _close(out, out_r, tol)
    G = H // KV
    for got, want in ((m, m_r), (l, l_r)):
        # fp32 on both sides from the same (rounded) inputs
        _rel(got, np.asarray(want).reshape(B, T, KV * G).transpose(0, 2, 1),
             FP32_TOL)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=[d for d, _ in DTYPES])
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_gradients_match_jax_vjp(case, dtype, tol):
    B, T, S, H, KV, dh, causal, window, q_offset, bk = case
    q, k, v, dout = _arrays(B, T, S, H, KV, dh, seed=T * S)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, dout))
    out_r, vjp = jax.vjp(
        lambda a, b, c: JA._blocked_flash(a, b, c, causal=causal,
                                          window=window, q_offset=q_offset,
                                          bk=bk), jq, jk, jv)
    dq_r, dk_r, dv_r = vjp(jdo)
    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = TA.attend(tq, tk, tv, causal=causal, window=window,
                    q_offset=q_offset, impl="flash_xla") if bk == 512 else \
        TA._blocked_flash(tq, tk, tv, causal=causal, window=window,
                          q_offset=q_offset, bk=bk)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv),
                                     torch.tensor(dout).to(tdt))
    _close(out, out_r, tol)
    for got, want, t in ((dq, dq_r, tq), (dk, dk_r, tk), (dv, dv_r, tv)):
        assert got.dtype == t.dtype
        _close(got, want, tol)


def test_backward_plain_on_reference_residuals():
    """N1's plain version on the reference's own saved (q, k, v, out, m,
    l) equals the reference's ``_blocked_flash_bwd``: the backward alone,
    with the forward's rounding taken out."""
    B, T, S, H, KV, dh = 1, 24, 50, 4, 1, 16
    q, k, v, dout = _arrays(B, T, S, H, KV, dh, seed=7)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, dout))
    kw = dict(causal=True, window=12, q_offset=26)
    _, res = JA._blocked_flash_fwd(jq, jk, jv, kw["causal"], kw["window"],
                                   kw["q_offset"], 16)
    want = JA._blocked_flash_bwd(kw["causal"], kw["window"], kw["q_offset"],
                                 16, res, jdo)
    _, _, _, out, m, l = (np.asarray(a) for a in res)
    G = H // KV

    def stat(a):
        return torch.tensor(a.reshape(B, T, KV * G).transpose(0, 2, 1)
                            .copy())
    got = tfa.flash_attention_bwd_plain(
        *(torch.tensor(a) for a in (q, k, v, out)), stat(m), stat(l),
        torch.tensor(dout), bk=16, **kw)
    for g, w in zip(got, want):
        _close(g, w, FP32_TOL)


def test_gradcheck_float64_plain_path():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 5, 4, 4, generator=g, dtype=torch.float64)
    k = torch.randn(1, 7, 2, 4, generator=g, dtype=torch.float64)
    v = torch.randn(1, 7, 2, 4, generator=g, dtype=torch.float64)
    for t in (q, k, v):
        t.requires_grad_()
    for causal, window, q_offset in ((True, None, 2), (True, 3, 2),
                                     (False, 4, 0)):
        assert torch.autograd.gradcheck(
            lambda a, b, c: TA._blocked_flash(
                a, b, c, causal=causal, window=window, q_offset=q_offset,
                bk=3), (q, k, v))


def test_rows_that_see_no_key_are_refused():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="sees no key"):
        tfa.flash_attention_train(q, k, k, causal=True, window=2,
                                   q_offset=2)
    with pytest.raises(ValueError, match="sees no key"):
        tfa.flash_attention_train(q, k, k, causal=True, window=None,
                                   q_offset=-1)


def test_cpu_dispatch_counts_no_launch():
    """CPU tensors run the plain versions: no kernel counter moves."""
    counters = (tfa.flash_attention_train.launches,
                tfa.flash_attention_bwd.dq_launches,
                tfa.flash_attention_bwd.dkdv_launches)
    before = [c.count for c in counters]
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    out = TA.attend(q, q[:, :, :1].detach(), q[:, :, :1].detach(),
                    impl="flash_xla")
    out.sum().backward()
    assert [c.count for c in counters] == before
    assert q.grad is not None and torch.isfinite(q.grad).all()
