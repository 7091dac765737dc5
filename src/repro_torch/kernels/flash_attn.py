"""Flash attention, forward: causal and/or sliding window, GQA (B9).

Port of ``repro.kernels.flash_attn``. q (B, Hq, T, D), k/v (B, Hkv, S, D)
with Hq % Hkv == 0 give (B, Hq, T, D): query head h attends kv head
h // (Hq // Hkv), and the queries sit at the end of the kv history
(position t + S − T). The arithmetic is the TPU kernel's blocked online
softmax: fp32 logits scaled after the dot, masked entries at
``NEG_INF = -1e30`` (a row fully masked in a tile gives exp(0) terms that
the next correction factor wipes out), p rounded to v's dtype before the
PV product, l clamped at 1e-30, the output cast to q's dtype.

* :func:`flash_attention_plain` — the plain version, in PyTorch, over the
  same 128-key tiles as the kernel (the tile decides where the running
  max is taken, and so how p rounds in bf16).
* :func:`launch_flash_attention` — B9 (``csrc/flash_attn.cu``, PTX
  helpers in ``csrc/sm90.cuh``). bf16 runs a Hopper kernel: one CTA of
  three warpgroups per (b, q head, 128-row query block), a producer
  whose one thread issues TMA loads of Q and of the K/V tiles into a
  two-stage mbarrier ring, and two consumers of 64 rows each that run
  ``wgmma`` for S = Q Kᵀ and for O += P V (P from registers, V read
  transposed by the descriptor), overlap one tile's softmax with the
  products FlashAttention-3's way, mask only the tiles that cross an
  edge, and store O by TMA; blocks run heaviest first. The
  host encodes the four tensor maps per call with
  ``cuTensorMapEncodeTiled``, reached through the CUDA runtime's driver
  entry point (no ``-lcuda``); a map the driver refuses raises, naming
  the tensor and its strides. float32 runs on CUDA cores (no TF32), one
  CTA per 64-row query block. Head dims 16, 32, 64 and 128. Any strides
  with a contiguous last dim, so (B, T, H, D) activations go in without
  a copy.
* :func:`flash_attention` — dispatch by device: a CPU tensor runs the
  plain version, a CUDA tensor launches B9 (counted in
  ``flash_attention.launches``).

The kernels are built at first use by ``_build`` (nvcc, ``sm_90a``);
``_build/<hash>/build.log`` keeps each kernel's registers, shared memory
and spills. The card tests are ``tests/test_torch_cuda.py`` (marker
``cuda``; the README gives the command that runs them on the card).

The kernel masks ragged T and S itself, so nothing is padded. The
reference's ``bq``/``bk`` (its VMEM tiling) have no counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.invariants import counter as _counter
from repro_torch.kernels import _build
from repro_torch.kernels._device import on_cpu

Tensor = torch.Tensor

NEG_INF = -1e30
BK = 128                     # keys per kv tile (kernel and plain version)
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def live_tiles(q_first: int, q_last: int, S: int, causal: bool,
               window: int | None) -> range:
    """Kv tiles that some query position in [q_first, q_last] sees."""
    hi = -(-S // BK)
    if causal:
        hi = min(hi, q_last // BK + 1)
    lo = 0
    if window is not None:
        lo = max(0, (q_first - window + 1) // BK)
    return range(lo, hi)


def _shape(q: Tensor, k: Tensor, v: Tensor):
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if (k.shape != (B, Hkv, S, D) or v.shape != k.shape or Hq % Hkv
            or T > S):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}: need q (B, Hq, T, D), k/v (B, Hkv, S, D) "
            f"with Hq % Hkv == 0 and T <= S")
    return B, Hq, Hkv, T, S, D


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> Tensor:
    """Plain version of B9: the reference's online softmax, one 128-key
    tile at a time, in fp32, GQA by viewing q as (B, Hkv, G·T, D)."""
    B, Hq, Hkv, T, S, D = _shape(q, k, v)
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    q_offset = S - T
    qf = q.float().reshape(B, Hkv, G * T, D)
    qpos = (torch.arange(T, device=q.device) + q_offset).repeat(G)[:, None]
    m = torch.full((B, Hkv, G * T, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, G * T, D, device=q.device)
    for j in live_tiles(q_offset, S - 1, S, causal, window):
        kb = k[:, :, j * BK:(j + 1) * BK].float()
        vb = v[:, :, j * BK:(j + 1) * BK]
        logits = (qf @ kb.transpose(-1, -2)) * scale
        kpos = torch.arange(j * BK, j * BK + kb.shape[2], device=q.device)
        mask = torch.ones(G * T, kb.shape[2], dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos
        if window is not None:
            mask &= kpos[None, :] > qpos - window
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vb.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, T, D).to(q.dtype)


def bf16_band(got: Tensor, want: Tensor) -> float:
    """How far a bf16 result of B9 lies from its plain version's, as a
    share of the band the kernel holds: 2⁻⁶·|want| per element (two bf16
    ulps of it) plus 2⁻⁸·max|want| over the element's row (one flipped
    bf16 rounding of a p that dominates the row). At most 1 is within the
    band. The two walk the same tiles, so they differ only by the fp32
    summation order and the bf16 roundings it flips."""
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    lim = 2.0 ** -6 * w + 2.0 ** -8 * w.amax(-1, keepdim=True)
    return float(torch.where(d == 0, 0.0, d / lim).max())


def _check(name: str, t: Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"{name}: expected a CUDA {dtype} tensor, got "
                         f"{t.dtype} on {t.device}")
    vec = 16 // t.element_size()
    if (t.stride(3) != 1 or any(s % vec for s in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: B9 needs a contiguous last dim, strides that are "
            f"multiples of {vec} elements and a 16-byte aligned base; got "
            f"strides {t.stride()}")


def launch_flash_attention(q: Tensor, k: Tensor, v: Tensor, *,
                           causal: bool = True, window: int | None = None,
                           scale: float | None = None) -> Tensor:
    """B9 on CUDA tensors. The output has q's dtype and memory layout."""
    B, Hq, Hkv, T, S, D = _shape(q, k, v)
    if q.dtype not in DTYPES or D not in HEAD_DIMS:
        raise ValueError(f"B9 takes {DTYPES} and head dims {HEAD_DIMS}, "
                         f"got {q.dtype} and D={D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check(name, t, q.dtype)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    scale = D ** -0.5 if scale is None else scale
    with torch.cuda.device(q.device):
        code = _build.library().flash_attn_fwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            int(q.dtype == torch.bfloat16), B, Hq, Hkv, T, S, D, strides,
            scale, int(causal), 0 if window is None else window,
            _build.stream_handle(q.device))
    if code < 0:
        if code == -5:
            raise RuntimeError("B9: the CUDA driver has no "
                               "cuTensorMapEncodeTiled")
        name, t = (("q", q), ("k", k), ("v", v), ("out", out))[-code - 1]
        raise RuntimeError(
            f"B9: cuTensorMapEncodeTiled refused {name} {tuple(t.shape)} "
            f"with strides {t.stride()} (elements)")
    _build.check(code, "flash_attention")
    return out


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int | None = None,
                    scale: float | None = None) -> Tensor:
    """q (B, Hq, T, D); k/v (B, Hkv, S, D) -> (B, Hq, T, D). CPU tensors
    run the plain version; CUDA tensors launch B9 (counted in
    ``flash_attention.launches``)."""
    if on_cpu(q, k, v, kernel="flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    out = launch_flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    flash_attention.launches.bump()
    return out


flash_attention.launches = _counter("launch.flash_attention")
