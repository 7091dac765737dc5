"""repro_torch.kernels.flash_attn (B9's plain version) against the JAX
reference: the Pallas kernel in interpret mode and ``ref.mha``.

Inputs are drawn with numpy from a seed and handed to both packages.
fp32 holds the reference's own band (2e-6 absolute at 0.3-scaled inputs,
``tests/test_kernels.py``); bf16 holds 1e-2 of the output's scale (the
two frameworks round bf16 matmuls and exps at different places). The
interpret-mode kernel runs with the port's key tile (``_bk``: 128 keys,
64 at head dim 256) where the tile decides the rounding of p (bf16) and
S allows it, and with 32-wide tiles elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attn as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

FP32_TOL = 2e-6


def _qkv(B, Hq, Hkv, T, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) * 0.3).astype(np.float32)
                 for shape in ((B, Hq, T, D), (B, Hkv, S, D),
                               (B, Hkv, S, D)))


def _port(arrs, dtype=torch.float32):
    return tuple(torch.tensor(a).to(dtype) for a in arrs)


def _jax(arrs, dtype=jnp.float32):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrs)


def _bk(S, D):
    """The Pallas kv tile that walks the port's tiles (block_keys(D)), or
    S itself when S is shorter; 64 where S is not a multiple of the tile
    (the Pallas kernel needs equal tiles)."""
    bk = tfa.block_keys(D)
    return bk if S < bk or S % bk == 0 else 64


def _err(got, want):
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


# (B, Hq, Hkv, T, S, D, causal, window): GQA groups 1, 2 and 4, T < S
CASES = [(2, 4, 2, 128, 128, 64, True, None),
         (2, 4, 2, 128, 128, 64, True, 32),
         (2, 4, 2, 128, 128, 64, False, None),
         (1, 4, 2, 64, 192, 32, True, None),
         (1, 4, 1, 64, 192, 32, True, 48),
         (1, 2, 2, 64, 64, 16, True, None),
         (1, 8, 2, 64, 128, 128, True, 100),
         (1, 4, 2, 128, 256, 64, True, 100),    # window narrower than a tile
         (1, 4, 4, 256, 256, 32, True, 200),    # window across two tiles
         # head dim 256 (recurrentgemma's): GQA 16:1 with a window across
         # the 64-key tiles; T < S
         (1, 16, 1, 128, 128, 256, True, 48),
         (1, 4, 2, 64, 128, 256, True, None)]


@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window", CASES)
def test_plain_matches_interpret_kernel_fp32(B, Hq, Hkv, T, S, D, causal,
                                             window):
    arrs = _qkv(B, Hq, Hkv, T, S, D)
    want = jfa.flash_attention(*_jax(arrs), causal=causal, window=window,
                               bq=32, bk=32, interpret=True)
    before = tfa.flash_attention.launches.count
    got = tfa.flash_attention(*_port(arrs), causal=causal, window=window)
    assert tfa.flash_attention.launches.count == before   # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == (B, Hq, T, D)
    assert _err(got, want) < FP32_TOL
    ref = jref.mha(*_jax(arrs), causal=causal, window=window)
    assert _err(got, ref) < FP32_TOL


@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window", CASES)
def test_plain_matches_interpret_kernel_bf16(B, Hq, Hkv, T, S, D, causal,
                                             window):
    arrs = _qkv(B, Hq, Hkv, T, S, D, seed=1)
    want = jfa.flash_attention(*_jax(arrs, jnp.bfloat16), causal=causal,
                               window=window, bq=64, bk=_bk(S, D),
                               interpret=True)
    got = tfa.flash_attention(*_port(arrs, torch.bfloat16), causal=causal,
                              window=window)
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(jnp.max(jnp.abs(want.astype(jnp.float32)))))
    assert _err(got, want) <= 1e-2 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_ref_mha_matches_reference(dtype, causal, window):
    arrs = _qkv(2, 6, 3, 40, 72, 32, seed=2)
    want = jref.mha(*_jax(arrs, getattr(jnp, dtype)), causal=causal,
                    window=window)
    got = tref.mha(*_port(arrs, getattr(torch, dtype)), causal=causal,
                   window=window)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = FP32_TOL if dtype == "float32" else 1e-2 * max(
        1.0, float(jnp.max(jnp.abs(want.astype(jnp.float32)))))
    assert _err(got, want) <= tol


@pytest.mark.parametrize("T,S,causal,window", [
    (50, 50, True, None),       # ragged self-attention: the reference pads
    (50, 50, True, 16),
    (20, 50, True, None),       # ragged T < S: the reference takes ref.mha
    (50, 50, False, None),
    (33, 97, True, 40),
    (129, 129, True, 100),      # one row past a 128-row block
    (127, 300, True, 200),      # T < S, ragged against 128-key tiles
    (255, 257, False, None)])
def test_ops_wrapper_matches_reference_on_ragged_shapes(T, S, causal,
                                                        window):
    arrs = _qkv(1, 4, 2, T, S, 32, seed=3)
    want = jops.flash_attention(*_jax(arrs), causal=causal, window=window,
                                bq=32, bk=32)
    got = tops.flash_attention(*_port(arrs), causal=causal, window=window,
                               bq=32, bk=32)
    assert got.shape == (1, 4, T, 32)
    assert _err(got, want) < FP32_TOL


def test_plain_takes_strided_views():
    """(B, T, H, D) activations viewed as (B, H, T, D), as attend hands
    them over, give the same result as contiguous inputs."""
    arrs = _qkv(2, 4, 2, 40, 40, 16, seed=4)
    views = tuple(torch.tensor(a).transpose(1, 2).contiguous()
                  .transpose(1, 2) for a in arrs)
    assert not views[0].is_contiguous()
    got = tfa.flash_attention(*views, window=8)
    want = tfa.flash_attention(*_port(arrs), window=8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("S,causal,window", [(200, True, None),
                                             (200, True, 70),
                                             (130, False, 5),
                                             (64, True, 1)])
def test_live_tiles_cover_exactly_the_visible_keys(S, causal, window):
    """The kv loop's range: every tile holding a visible key, no other
    (checked per 64-row query block against brute-force masks)."""
    BK = tfa.BK
    for T in (S, S // 2 + 1):
        off = S - T
        for r0 in range(0, T, 64):
            qpos = np.arange(r0, min(r0 + 64, T)) + off
            kpos = np.arange(S)
            vis = np.ones((qpos.size, S), bool)
            if causal:
                vis &= kpos[None] <= qpos[:, None]
            if window is not None:
                vis &= kpos[None] > qpos[:, None] - window
            want = sorted({int(k) // BK for k in np.nonzero(vis)[1]})
            got = list(tfa.live_tiles(int(qpos[0]), int(qpos[-1]), S,
                                      causal, window))
            assert got == want, (T, r0)


def test_launcher_refuses_cpu_tensors_and_bad_shapes():
    q, k, v = _port(_qkv(1, 4, 2, 16, 16, 32))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.launch_flash_attention(q, k, v)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        tfa.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="T <= S"):
        tfa.flash_attention(q, k[:, :, :8], v[:, :, :8])
    with pytest.raises(ValueError, match="head dims"):
        tfa.launch_flash_attention(q[..., :24], k[..., :24], v[..., :24])
