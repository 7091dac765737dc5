"""The band argument for F's and N1's split-TF32 products, on the CPU.

N1 (``csrc/flash_bwd.cu``) runs the training attention backward's
products on the tensor cores as a three-term TF32 split: each fp32
operand x becomes big = tf32(x) (rounded to nearest) and small =
tf32(x - big); a product is big·big + big·small + small·big, summed in
fp32, and small·small is dropped. This test emulates that arithmetic in
torch on the CPU — TF32 as the fp32 bit pattern rounded to nearest at
bit 13 and masked, exact partial products, fp32 sums in chunks as the
kernels take them (32 columns of D for S and dP, as N1-dq does; 32-key
tiles for dq, 64-row tiles for dk and dv) — and holds the emulated
backward within 1e-5 × max(1, max|ref|) of the reference's
``_blocked_flash_bwd`` (JAX on the CPU, on the reference forward's own
residuals): the band the kernels are held to on the card. The same
emulation with plain TF32 products (one term) falls outside that band,
so the band tells the two apart. The emulation lives here, not in the
port: the port's plain version stays the reference's fp32 arithmetic.

At head dim 256 (``flash_bwd_dq_d256``, ``flash_bwd_dkdv_d256``) the
emulation takes those kernels' own tiling: S and dP as two D-halves of
four 32-column chunks, dq over 16-key tiles, dk and dv over 32-row chunks
summed a head group at a time (min(group, 4) groups of a kv head's query
heads, added in order); in both variants (bf16-valued k, v and dout have
zero small halves, so the split's terms are the exact variant's), with
GQA 16:1 under a window and the cancelling case on an uneven group.

F (``csrc/flash_fwd.cu``), the forward, takes the same split for S =
Qs Kᵀ (chunks of 32 columns of D) and for O += P V (one chunk a 32-key
tile, added after the online softmax's rescale); with bf16 or fp16 k and
v (its exact variant) it skips their zero small halves, so that S and O
take two terms each. Its m is the row max's logit taken again as one
fp32 fma chain over d, the fp32 product's own order, and l is moved onto
that m. The emulated forward walks those tiles and is held to the same
band against the reference's ``_blocked_flash_fwd`` at the reference's
own block width (512 keys, or S): out within 1e-5 × max(1, max|ref|), m
and l within 1e-5 relative.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.kernels import flash_attn as tfa

FP32_TOL = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value, ties away from zero (PTX
    ``cvt.rna.tf32.f32``): the low 13 mantissa bits zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: str):
    """One of the kernel's products: three split terms ("split"), two
    when b is exact in TF32 ("exact": b's small half skipped, as F's
    exact variant skips K's and V's), or plain TF32 ("tf32")."""
    ab, bb = tf32(a), tf32(b)
    if terms == "tf32":
        return torch.einsum(eq, ab, bb)
    cross = torch.einsum(eq, tf32(a - ab), bb)
    if terms != "exact":
        cross = torch.einsum(eq, ab, tf32(b - bb)) + cross
    return torch.einsum(eq, ab, bb) + cross


def emulated_bwd(q, k, v, out, m, l, dout, *, causal, window, q_offset,
                 terms):
    """N1's backward with ``terms`` products: q, out, dout (B, T, H, D),
    k, v (B, S, KV, D), m, l (B, T, H); returns (dq, dk, dv) fp32."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qs = q * scale
    delta = (dout * out).sum(-1)                         # (B, T, H)
    kh, vh = (x.repeat_interleave(G, dim=2) for x in (k, v))

    def over_d(x, y):
        acc = torch.zeros(B, H, T, S)
        for c in range(0, D, 32):
            acc = acc + product("bthd,bshd->bhts", x[..., c:c + 32],
                                y[..., c:c + 32], terms)
        return acc
    qpos = torch.arange(T)[:, None] + q_offset
    kpos = torch.arange(S)[None, :]
    seen = torch.ones(T, S, dtype=torch.bool)
    if causal:
        seen &= kpos <= qpos
    if window is not None:
        seen &= kpos > qpos - window
    st = lambda x: x.permute(0, 2, 1)[..., None]         # (B, H, T, 1)
    p = torch.where(seen, torch.exp(over_d(qs, kh) - st(m)) / st(l), 0.0)
    ds = p * (over_d(dout, vh) - st(delta))
    dq = torch.zeros(B, T, H, D)
    for j in range(0, S, 32):
        dq = dq + product("bhts,bshd->bthd", ds[..., j:j + 32],
                          kh[:, j:j + 32], terms)
    dkh, dvh = torch.zeros(B, S, H, D), torch.zeros(B, S, H, D)
    for r in range(0, T, 64):
        rows = slice(r, r + 64)
        dvh = dvh + product("bhts,bthd->bshd", p[:, :, rows], dout[:, rows],
                            terms)
        dkh = dkh + product("bhts,bthd->bshd", ds[:, :, rows], qs[:, rows],
                            terms)
    def group(x):
        return x.reshape(B, S, KV, G, D).sum(3)
    return dq * scale, group(dkh), group(dvh)


# (B, T, S, H, KV, D, causal, window, q_offset, cancel): causal, windowed,
# GQA groups 1, 2 and 4, queries past a longer history; cancel: q × 4 for
# peaked logits and dout = out + 1e-3 noise, so that dP - D cancels
CASES = [
    (2, 40, 40, 4, 2, 16, True, None, 0, False),
    (1, 70, 70, 4, 4, 32, True, 24, 0, False),
    (1, 48, 90, 8, 2, 64, True, 30, 42, False),
    (1, 96, 96, 4, 1, 128, True, None, 0, False),
    (1, 128, 128, 4, 2, 128, True, None, 0, True),
]


def _reference(case, seed=3):
    """The inputs, the reference forward's residuals as torch tensors and
    the reference's ``_blocked_flash_bwd``."""
    B, T, S, H, KV, D, causal, window, q_offset, cancel = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    if cancel:
        q = q * 4
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, res = JA._blocked_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, window, q_offset,
                                   16)
    out = np.asarray(res[3])
    dout = (out + 1e-3 * rng.standard_normal(out.shape)).astype(np.float32) \
        if cancel else rng.standard_normal(out.shape).astype(np.float32)
    want = JA._blocked_flash_bwd(causal, window, q_offset, 16, res,
                                 jnp.asarray(dout))
    m, l = (torch.tensor(np.asarray(a).reshape(B, T, H)) for a in res[4:])
    ts = [torch.tensor(a) for a in (q, k, v, out)]
    return ts, m, l, torch.tensor(dout), kw, [np.asarray(w) for w in want]


def _errors(case, terms):
    (q, k, v, out), m, l, dout, kw, want = _reference(case)
    got = emulated_bwd(q, k, v, out, m, l, dout, terms=terms, **kw)
    return [float(np.abs(g.numpy() - w).max()) / max(1.0, np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES)
def test_split_tf32_within_band(case):
    """The three-term split holds dq, dk and dv within 1e-5 of each
    result's scale, as fp32 products do."""
    errs = _errors(case, "split")
    assert max(errs) <= FP32_TOL, errs


@pytest.mark.parametrize("case", CASES)
def test_plain_tf32_outside_band(case):
    """One TF32 term a product misses the band: the test has teeth."""
    errs = _errors(case, "tf32")
    assert max(errs) > FP32_TOL, errs


def emulated_fwd(q, k, v, *, causal, window, q_offset, terms, nk=32,
                 halves=1):
    """F with ``terms`` products: q (B, T, H, D), k, v (B, S, KV, D);
    returns (out, m, max(l, 1e-30)), the statistics (B, T, H). It walks
    ``nk``-key tiles as the kernel does: S over D in chunks of 32
    columns, added in order within each of ``halves`` D-halves and then
    the halves (one a warpgroup at head dim 256), the online softmax,
    then O = O·corr + P V, one chunk a tile; m is the first max key's
    logit again, exact and rounded once, and l moves onto it."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qs = q * D ** -0.5
    kh, vh = (x.repeat_interleave(G, dim=2) for x in (k, v))
    qpos = torch.arange(T)[:, None] + q_offset
    m = torch.full((B, H, T), tfa.NEG_INF)
    l = torch.zeros(B, H, T)
    acc = torch.zeros(B, H, T, D)
    arg = torch.zeros(B, H, T, dtype=torch.long)   # the max's key
    for j in range(0, S, nk):
        kb, vb = kh[:, j:j + nk], vh[:, j:j + nk]
        parts = []
        for h0 in range(0, D, D // halves):
            part = torch.zeros(B, H, T, kb.shape[1])
            for c in range(h0, h0 + D // halves, 32):
                part = part + product("bthd,bshd->bhts", qs[..., c:c + 32],
                                      kb[..., c:c + 32], terms)
            parts.append(part)
        s = parts[0] if halves == 1 else parts[0] + parts[1]
        kpos = torch.arange(j, j + kb.shape[1])[None, :]
        seen = torch.ones(T, kb.shape[1], dtype=torch.bool)
        if causal:
            seen &= kpos <= qpos
        if window is not None:
            seen &= kpos > qpos - window
        s = torch.where(seen, s, tfa.NEG_INF)
        top, at = s.max(-1)
        arg = torch.where(top > m, at + j, arg)
        m_new = torch.maximum(m, top)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + product("bhts,bshd->bhtd", p, vb,
                                              terms)
        m = m_new
    lsafe = torch.clamp(l, min=1e-30)
    out = (acc / lsafe[..., None]).permute(0, 2, 1, 3)
    m_out, l_out = _exact_m(qs, kh, m, l, arg)
    return out, m_out.permute(0, 2, 1), l_out.permute(0, 2, 1)


def emulated_fwd256(q, k, v, *, causal, window, q_offset, terms):
    """F at head dim 256 (``flash_fwd_d256``) in its own tiling: 16-key
    tiles (32 in the exact variant, whose k and v have no small halves),
    S as two D-halves of four 32-column chunks each, the halves' partial
    sums added (the swap through shared memory), one chunk of P V a tile
    (each warpgroup's D-half of O alike)."""
    return emulated_fwd(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, terms=terms,
                        nk=32 if terms == "exact" else 16, halves=2)


def _exact_m(qs, kh, m, l, arg):
    """The kernel's m (``exact_logit``): the max key ``arg``'s logit again,
    summed in fp64 (each product of two fp32 values exact) and rounded
    once, l moved onto it; m, l, arg (B, H, T)."""
    B, H, T = m.shape
    kmax = torch.gather(kh.permute(0, 2, 1, 3), 2,
                        arg[..., None].expand(B, H, T, kh.shape[-1]))
    exact = (qs.permute(0, 2, 1, 3).double() * kmax.double()).sum(-1)
    seen = m > tfa.NEG_INF
    m_out = torch.where(seen, exact.float(), m)
    l_out = torch.clamp(torch.where(seen, l * torch.exp(m - m_out), l),
                        min=1e-30)
    return m_out, l_out


def _exact_row_max(q, k, *, causal, window, q_offset):
    """Each row's largest visible logit in fp64, from the fp32 qs = q·scale
    the reference forms (the products exact): (B, T, H)."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    qs = (torch.tensor(q) * D ** -0.5).double()
    kh = torch.tensor(k).double().repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bthd,bshd->bths", qs, kh)
    qpos = torch.arange(T)[:, None] + q_offset
    kpos = torch.arange(S)[None, :]
    seen = torch.ones(T, S, dtype=torch.bool)
    if causal:
        seen &= kpos <= qpos
    if window is not None:
        seen &= kpos > qpos - window
    return torch.where(seen[:, None], logits, -torch.inf).amax(-1).numpy()


# the forward's cases: the backward's, and a peaked one (q × 4) with a
# window, queries past a longer history and a GQA group of 4
FWD_CASES = CASES + [(1, 100, 164, 8, 2, 64, True, 40, 64, True)]


def _fwd_errors(case, terms, bf16_kv, fwd=emulated_fwd):
    """F's emulation ``fwd`` against the reference's ``_blocked_flash_fwd``
    (at ``_blocked_flash``'s block width, min(512, S)): out × max(1,
    max|ref|), l relative, and m relative to the exact row max. The
    reference's m is an fp32 dot summed in XLA's CPU order, which lies up
    to 2e-3 relative from the exact logit where a row's max is near 0; the
    kernel's m is the exact logit rounded once. So m is held to the fp64
    row max itself, which no summation order moves. ``bf16_kv``: k and v rounded to bf16 values first (the
    exact variant's inputs), on both sides. An 11th entry of ``case`` is
    the seed of a numpy draw of q, an unused dout, k and v in that order
    (the card test's), else q, k, v are drawn from seed 7."""
    B, T, S, H, KV, D, causal, window, q_offset, peaked = case[:10]
    if len(case) > 10:
        rng = np.random.default_rng(case[10])
        q, _ = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                for _ in range(2))
    else:
        rng = np.random.default_rng(7)
        q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    if peaked:
        q = q * 4
    if bf16_kv:
        k, v = (torch.tensor(a).bfloat16().float().numpy() for a in (k, v))
    want_out, res = JA._blocked_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal, window,
                                          q_offset, min(512, S))
    want = [np.asarray(want_out)] + [np.asarray(a).reshape(B, T, H)
                                     for a in res[4:]]
    got = fwd(*(torch.tensor(a) for a in (q, k, v)), causal=causal,
              window=window, q_offset=q_offset, terms=terms)
    (out, m, l), (w_out, _, w_l) = (x.numpy() for x in got), want
    m_x = _exact_row_max(q, k, causal=causal, window=window,
                         q_offset=q_offset)
    return [float(np.abs(out - w_out).max())
            / max(1.0, float(np.abs(w_out).max())),
            float((np.abs(m - m_x) / np.abs(m_x)).max()),
            float((np.abs(l - w_l) / np.abs(w_l)).max())]


@pytest.mark.parametrize("terms,bf16_kv", [("split", False),
                                           ("exact", True)])
@pytest.mark.parametrize("case", FWD_CASES)
def test_forward_split_tf32_within_band(case, terms, bf16_kv):
    """F's split (three terms; two with bf16-valued k and v, the exact
    variant) holds out, m and l within 1e-5 of the reference's forward
    (scales as ``_fwd_errors`` gives them), peaked logits included."""
    errs = _fwd_errors(case, terms, bf16_kv)
    assert max(errs) <= FP32_TOL, errs


@pytest.mark.parametrize("case", FWD_CASES)
def test_forward_plain_tf32_outside_band(case):
    """One TF32 term a product misses the forward's band too."""
    errs = _fwd_errors(case, "tf32", False)
    assert max(errs) > FP32_TOL, errs


# (B, T, S, H, KV, D, causal, window, q_offset, peaked[, seed]) at head dim
# 256: GQA 16:1 under a window (recurrentgemma's shape), queries past a
# longer history with two kv heads, peaked logits with six query heads a
# kv head, and fault C-1's case (the card test's draw, seed T + S + H)
FWD_CASES_256 = [
    (1, 128, 128, 16, 1, 256, True, 48, 0, False),
    (1, 64, 100, 8, 2, 256, True, 40, 36, False),
    (1, 96, 96, 6, 1, 256, True, None, 0, True),
    (1, 200, 200, 6, 1, 256, True, 64, 0, False, 406),
]


@pytest.mark.parametrize("terms,bf16_kv", [("split", False),
                                           ("exact", True)])
@pytest.mark.parametrize("case", FWD_CASES_256)
def test_forward_split_tf32_within_band_head_dim_256(case, terms, bf16_kv):
    """F's head-dim-256 tiling (``emulated_fwd256``) holds out, m and l
    within 1e-5 of the reference's forward in both variants: the
    three-term split on 16-key tiles, and with bf16-valued k and v the
    exact variant's two terms on 32-key tiles."""
    errs = _fwd_errors(case, terms, bf16_kv, fwd=emulated_fwd256)
    assert max(errs) <= FP32_TOL, errs


@pytest.mark.parametrize("case", FWD_CASES_256)
def test_forward_plain_tf32_outside_band_head_dim_256(case):
    """One TF32 term a product misses the band at head dim 256 too."""
    errs = _fwd_errors(case, "tf32", False, fwd=emulated_fwd256)
    assert max(errs) > FP32_TOL, errs


def emulated_bwd256(q, k, v, out, m, l, dout, *, causal, window, q_offset,
                    terms):
    """N1 at head dim 256 (``flash_bwd_dq_d256``, ``flash_bwd_dkdv_d256``)
    with ``terms`` products, in the kernels' own tiling: S and dP over D
    as two D-halves (one a warpgroup) of four 32-column chunks each, the
    halves added; dq over 16-key tiles (one chunk each); dk and dv over
    32-row chunks (two a 64-row tile), one running sum a head group of
    the kv head's query heads (min(group, 4) groups, heads and rows in
    order), the groups' sums added in group order."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qs = q * scale
    delta = (dout * out).sum(-1)
    kh, vh = (x.repeat_interleave(G, dim=2) for x in (k, v))

    def over_d(x, y):
        halves = []
        for h0 in (0, D // 2):
            acc = torch.zeros(B, H, T, S)
            for c in range(h0, h0 + D // 2, 32):
                acc = acc + product("bthd,bshd->bhts", x[..., c:c + 32],
                                    y[..., c:c + 32], terms)
            halves.append(acc)
        return halves[0] + halves[1]
    qpos = torch.arange(T)[:, None] + q_offset
    kpos = torch.arange(S)[None, :]
    seen = torch.ones(T, S, dtype=torch.bool)
    if causal:
        seen &= kpos <= qpos
    if window is not None:
        seen &= kpos > qpos - window
    st = lambda x: x.permute(0, 2, 1)[..., None]         # (B, H, T, 1)
    p = torch.where(seen, torch.exp(over_d(qs, kh) - st(m)) / st(l), 0.0)
    ds = p * (over_d(dout, vh) - st(delta))
    dq = torch.zeros(B, T, H, D)
    for j in range(0, S, 16):
        dq = dq + product("bhts,bshd->bthd", ds[..., j:j + 16],
                          kh[:, j:j + 16], terms)
    ng = min(G, 4)
    dk, dv = torch.zeros(B, S, KV, D), torch.zeros(B, S, KV, D)
    for g in range(ng):
        pk, pv = torch.zeros(B, S, KV, D), torch.zeros(B, S, KV, D)
        for i in range(G * g // ng, G * (g + 1) // ng):
            hs = [kv * G + i for kv in range(KV)]   # head i of each kv head
            for r in range(0, T, 32):
                rows = slice(r, r + 32)
                pv = pv + product("bhts,bthd->bshd", p[:, hs, rows],
                                  dout[:, rows][:, :, hs], terms)
                pk = pk + product("bhts,bthd->bshd", ds[:, hs, rows],
                                  qs[:, rows][:, :, hs], terms)
        dk, dv = dk + pk, dv + pv
    return dq * scale, dk, dv


# (B, T, S, H, KV, D, causal, window, q_offset, cancel) at head dim 256:
# GQA 16:1 with a window (recurrentgemma's shape, four head groups of
# four), queries past a longer history with two kv heads, and the
# cancelling case with six query heads a kv head (head groups of 1, 2, 1,
# 2)
CASES_256 = [
    (1, 128, 128, 16, 1, 256, True, 48, 0, False),
    (1, 64, 100, 8, 2, 256, True, 40, 36, False),
    (1, 96, 96, 6, 1, 256, True, None, 0, True),
]


@functools.lru_cache(maxsize=None)
def _reference256(case, exact):
    """The inputs, the reference forward's residuals and the reference's
    ``_blocked_flash_bwd`` at head dim 256 (one key block: the reference's
    arithmetic at any width), as numpy arrays; ``exact``: k, v and dout
    rounded to bf16 values first (the exact variant's inputs), on both
    sides. Cached: the split and plain-TF32 tests share a case's."""
    B, T, S, H, KV, D, causal, window, q_offset, cancel = case
    rng = np.random.default_rng(11)
    bf = (lambda a: torch.tensor(a).bfloat16().float().numpy()) if exact \
        else (lambda a: a)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (bf(rng.standard_normal((B, S, KV, D)).astype(np.float32))
            for _ in range(2))
    if cancel:
        q = q * 4
    _, res = JA._blocked_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, window, q_offset,
                                   S)
    out = np.asarray(res[3])
    dout = bf((out + 1e-3 * rng.standard_normal(out.shape)).astype(
        np.float32) if cancel else rng.standard_normal(out.shape).astype(
            np.float32))
    want = JA._blocked_flash_bwd(causal, window, q_offset, S, res,
                                 jnp.asarray(dout))
    m, l = (np.asarray(a).reshape(B, T, H) for a in res[4:])
    return (q, k, v, out, m, l, dout), tuple(np.asarray(w) for w in want)


def _errors256(case, terms, exact):
    """The emulated head-dim-256 backward against the reference's, each
    result's error over max(1, max|ref|)."""
    _, _, _, _, _, _, causal, window, q_offset, _ = case
    ins, want = _reference256(case, exact)
    got = emulated_bwd256(*(torch.tensor(a) for a in ins), causal=causal,
                          window=window, q_offset=q_offset, terms=terms)
    return [float(np.abs(g.numpy() - w).max()) / max(1.0, float(
        np.abs(w).max())) for g, w in zip(got, want)]


@pytest.mark.parametrize("exact", [False, True], ids=["split", "exact"])
@pytest.mark.parametrize("case", CASES_256)
def test_split_tf32_within_band_head_dim_256(case, exact):
    """N1's head-dim-256 tiling holds dq, dk and dv within 1e-5 of each
    result's scale in both variants: the three-term split, and with
    bf16-valued k, v and dout the terms the exact variant keeps."""
    errs = _errors256(case, "split", exact)
    assert max(errs) <= FP32_TOL, errs


@pytest.mark.parametrize("case", CASES_256)
def test_plain_tf32_outside_band_head_dim_256(case):
    """One TF32 term a product misses the band at head dim 256 too."""
    errs = _errors256(case, "tf32", False)
    assert max(errs) > FP32_TOL, errs


def test_bf16_inputs_have_zero_small_halves():
    """What the exact variant skips: bf16 and fp16 values upcast to fp32
    are TF32 values, so their small halves are zero; fp32 ones are not."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g)
    for dt in (torch.bfloat16, torch.float16):
        y = x.to(dt).float()
        assert tfa.tf32_exact(x.to(dt))
        assert torch.equal(tf32(y), y)
        assert not bool((tf32(y - tf32(y)) != 0).any())
    assert not tfa.tf32_exact(x)
    assert bool((tf32(x - tf32(x)) != 0).any())


@pytest.mark.parametrize("dt,exact", [(torch.float32, False),
                                      (torch.bfloat16, True),
                                      (torch.float16, True)])
def test_bwd_operands_take_exact_from_dtypes(dt, exact):
    """The exact variant is chosen only by ``bwd_operands``, from k's, v's
    and dout's own dtypes; one fp32 tensor among them turns it off. The
    operands are fp32 copies with q scaled."""
    g = torch.Generator().manual_seed(1)
    q, k, v, out, dout = (torch.randn(1, 8, 2, 16, generator=g).to(dt)
                          for _ in range(5))
    ops = tfa.bwd_operands(q, k, v, out, dout)
    assert ops.exact is exact
    assert all(t.dtype == torch.float32 for t in ops[:5])
    assert torch.equal(ops.qs, q.float() * 16 ** -0.5)
    assert torch.equal(ops.k, k.float())
    assert tfa.bwd_operands(q, k, v.float(), out, dout).exact is False
