"""B9's bf16 band (``flash_attn.bf16_band``) tells a right kernel from a
wrong one.

The card tests and chip_smoke hold B9's bf16 output to its plain version
within the band: two bf16 ulps of each element plus 2⁻⁸ of its row's
largest. Here, on the CPU, the plain version is rebuilt with a fault at a
time, the kind a tiled kernel can have (a skipped interior tile, a mask
off by one key, a rescale missed or misplaced); each must leave the
band. The same walk with its dots summed in float64 (another summation
order, as the kernel's wgmma has) must stay inside it. Inputs are drawn
with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as tfa

SHAPE = dict(B=1, Hq=4, Hkv=2, T=512, S=512, D=64)


def _qkv(B, Hq, Hkv, T, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                 .bfloat16()
                 for s in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D)))


def _walk(q, k, v, window, fault=None, dots=torch.float32):
    """flash_attention_plain's causal walk over 128-key tiles, with one
    fault: "tile" skips tile 2, "diagonal" hides the diagonal key,
    "window" hides the window's oldest key, "rescale" leaves O unscaled at
    tile 3, "late" rescales O after adding tile 2's and later P V."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G, BK = Hq // Hkv, tfa.BK
    qf = q.to(dots).reshape(B, Hkv, G * T, D)
    qpos = (torch.arange(T) + S - T).repeat(G)[:, None]
    m = torch.full((B, Hkv, G * T, 1), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, G * T, D)
    for j in tfa.live_tiles(S - T, S - 1, S, True, window):
        if fault == "tile" and j == 2:
            continue
        kb = k[:, :, j * BK:(j + 1) * BK]
        vb = v[:, :, j * BK:(j + 1) * BK]
        logits = (qf @ kb.to(dots).transpose(-1, -2)).float() * D ** -0.5
        kpos = torch.arange(j * BK, j * BK + kb.shape[2])[None, :]
        mask = kpos < qpos if fault == "diagonal" else kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window + (fault == "window")
        logits = torch.where(mask, logits, tfa.NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = (p.bfloat16().to(dots) @ vb.to(dots)).float()
        if fault == "rescale" and j == 3:
            acc = acc + pv
        elif fault == "late" and j >= 2:
            acc = (acc + pv) * corr
        else:
            acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, T, D).bfloat16()


@pytest.mark.parametrize("window", [None, 300])
def test_walk_is_the_plain_version(window):
    q, k, v = _qkv(**SHAPE)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    assert torch.equal(_walk(q, k, v, window), want)


@pytest.mark.parametrize("window", [None, 300])
def test_band_holds_another_summation_order(window):
    q, k, v = _qkv(**SHAPE)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    got = _walk(q, k, v, window, dots=torch.float64)
    assert not torch.equal(got, want)
    assert tfa.bf16_band(got, want) <= 0.75


@pytest.mark.parametrize("window,fault", [
    (None, "tile"), (None, "diagonal"), (None, "rescale"), (None, "late"),
    (300, "tile"), (300, "diagonal"), (300, "window"), (300, "rescale"),
    (300, "late")])
def test_band_catches_kernel_faults(window, fault):
    q, k, v = _qkv(**SHAPE)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    got = _walk(q, k, v, window, fault)
    assert tfa.bf16_band(got, want) > 4.0


def test_band_is_zero_on_equal_and_infinite_off_a_zero_row():
    q, k, v = _qkv(**SHAPE)
    out = tfa.flash_attention_plain(q, k, v)
    assert tfa.bf16_band(out, out.clone()) == 0.0
    zero = torch.zeros(1, 1, 2, 4, dtype=torch.bfloat16)
    off = zero.clone()
    off[0, 0, 1, 0] = 1e-3
    assert tfa.bf16_band(off, zero) == float("inf")
