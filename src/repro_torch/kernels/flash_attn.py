"""Flash attention: the prefill's forward (B9), and the training
attention's forward with its softmax statistics (F) and backward (N1).

Port of ``repro.kernels.flash_attn``. q (B, Hq, T, D), k/v (B, Hkv, S, D)
with Hq % Hkv == 0 give (B, Hq, T, D): query head h attends kv head
h // (Hq // Hkv), and the queries sit at the end of the kv history
(position t + S − T). The arithmetic is the TPU kernel's blocked online
softmax: fp32 logits scaled after the dot, masked entries at
``NEG_INF = -1e30`` (a row fully masked in a tile gives exp(0) terms that
the next correction factor wipes out), p rounded to v's dtype before the
PV product, l clamped at 1e-30, the output cast to q's dtype.

* :func:`flash_attention_plain` — the plain version, in PyTorch, over the
  same key tiles as the bf16 kernel, :func:`block_keys` (the tile decides
  where the running max is taken, and so how p rounds in bf16).
* :func:`launch_flash_attention` — B9 (``csrc/flash_attn.cu``, PTX
  helpers in ``csrc/sm90.cuh``). bf16 runs a Hopper kernel: one CTA of
  three warpgroups per (b, q head, 128-row query block), a producer
  whose one thread issues TMA loads of Q and of the K/V tiles into a
  two-stage mbarrier ring, and two consumers of 64 rows each that run
  ``wgmma`` for S = Q Kᵀ and for O += P V (P from registers, V read
  transposed by the descriptor), overlap one tile's softmax with the
  products FlashAttention-3's way, mask only the tiles that cross an
  edge, and store O by TMA; blocks run heaviest first; 128-key tiles, 64
  at head dim 256. The
  host encodes the four tensor maps per call with
  ``cuTensorMapEncodeTiled``, reached through the CUDA runtime's driver
  entry point (no ``-lcuda``); a map the driver refuses raises, naming
  the tensor and its strides. float32 runs on CUDA cores (no TF32), one
  CTA per 128-row query block (64 rows and 32-key tiles at head dim 256).
  Head dims 16, 32, 64, 128 and 256 (recurrentgemma's). Any strides with
  a contiguous last dim, so (B, T, H, D) activations go in without a
  copy.
* :func:`flash_attention` — dispatch by device: a CPU tensor runs the
  plain version, a CUDA tensor launches B9 (counted in
  ``flash_attention.launches``).

The kernels are built at first use by ``_build`` (nvcc, ``sm_90a``);
``_build/<hash>/build.log`` keeps each kernel's registers, shared memory
and spills. The card tests are ``tests/test_torch_cuda.py`` (marker
``cuda``; the README gives the command that runs them on the card).

The kernel masks ragged T and S itself, so nothing is padded. The
reference's ``bq``/``bk`` (its VMEM tiling) have no counterpart.

The training attention (the model's ``flash_xla``; no TPU kernel: the
reference's ``models/attention.py:84-196`` is plain JAX under a custom
VJP) takes the model's layout, q (B, T, H, dh) and k/v (B, S, KV, dh),
with query t at position t + q_offset:

* :func:`flash_attention_train_plain` / :func:`flash_attention_bwd_plain`
  — the reference's ``_blocked_flash_fwd`` and ``_blocked_flash_bwd``
  step by step over ``bk``-key blocks (fp32 arithmetic; fp64 inputs
  compute in fp64, for ``gradcheck``);
* :func:`launch_flash_attention_train` — F (``csrc/flash_fwd.cu``), fed
  q·scale (the reference scales q in fp32 before the dot) with scale 1,
  storing m and max(l, 1e-30) per row. Its products run on the tensor
  cores as N1's three-term TF32 split (fp32-accurate): a first kernel
  splits each 32-key tile of k and v once (v transposed), then
  ``flash_f32_stats`` takes a 128-row query block a CTA, two warpgroups
  of 64 rows fed by a producer's bulk copies. With bf16 or fp16 k and v
  (:func:`tf32_exact`) it skips their zero small halves. m is the first
  max key's logit again, exact and rounded once
  (:func:`exact_max_logit`), as the plain version takes it;
* :func:`launch_flash_bwd_dq` / :func:`launch_flash_bwd_dkdv` — N1
  (``csrc/flash_bwd.cu``), its products on the tensor cores as a
  three-term TF32 split (fp32-accurate): N1-dq, a CTA a 64-row query
  block, computes D = Σ dout·out and dq; N1-dkdv, a CTA a 32-key block,
  dk and dv over the GQA group's query heads. No atomics: every sum has
  a fixed order. Both take :func:`bwd_operands`, which also says whether
  k, v and dout were bf16 or fp16 (:func:`tf32_exact`): then N1 skips
  their zero small halves;
* head dim 256 (recurrentgemma-9b's local attention): F and N1 run the
  split products on tiles both warpgroups share, each owning one D-half
  of the running O (F), dQᵀ or dKᵀ and dVᵀ (64 registers a thread). F
  (``flash_fwd_d256``, fed by the same pre-pass at 16-key tiles, 32 in
  the exact variant): a 64-row query block a CTA, raw Q once (64 KB), a
  producer's bulk copies of the split tiles into a two-stage ring (128
  KB), the two D-halves' partial S swapped through shared memory so that
  both warpgroups run one softmax, 213,024 B (229,408 exact). N1
  (``flash_bwd_dq_d256``, ``flash_bwd_dkdv_d256``): raw 64-row Q and dO
  tiles (128 KB),
  K and V at 16 keys a tile (64 KB: one split stage, or in N1-dq's exact
  variant a two-stage ``cp.async`` ring of the exact tiles; N1-dkdv's
  exact variant takes 32-key blocks, big halves only), 213,248 B
  (N1-dq) and 213,120 B (N1-dkdv; 229,504 exact) of the 232,448 a block
  may take. Each product's sums run in chunks of 4 k-steps, the two
  D-halves' partial S and dP swapped through shared memory. N1-dkdv
  cuts a kv head's group of query heads into min(group, 4) head groups,
  a CTA each (1,024 CTAs at recurrentgemma's training shape, 512 in the
  exact variant, where one a key block gave 128 on 132 SMs); their
  partial dk and dv go to a scratch buffer (32 MiB there) that
  ``flash_bwd_dkdv_d256_sum`` adds in head-group order, so the bits are
  the same every run. Bounded by the split products on the tensor cores
  (495 TFLOP/s on an H100 SXM at 700 W), held by each step's latency:
  on an H100 80GB HBM3 at 700 W N1-dq and N1-dkdv take 4.60 and 5.35 ms
  in fp32 at that shape (2.90 and 2.43 with bf16 inputs), together 0.75×
  ``torch.autograd.grad`` through SDPA;
* :func:`flash_attention_train` / :func:`flash_attention_bwd` — dispatch
  by device, counted in ``launch.flash_attention_train``,
  ``launch.flash_bwd_dq`` and ``launch.flash_bwd_dkdv``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.analysis.invariants import counter as _counter
from repro_torch.kernels import _build
from repro_torch.kernels._device import on_cpu

Tensor = torch.Tensor

NEG_INF = -1e30
BK = 128                     # keys per kv tile up to head dim 128
HEAD_DIMS = (16, 32, 64, 128, 256)          # B9's
TRAIN_HEAD_DIMS = (16, 32, 64, 128, 256)    # F's and N1's
DTYPES = (torch.float32, torch.bfloat16)


def block_keys(D: int) -> int:
    """Keys per kv tile of B9's bf16 kernel and of the plain version at
    head dim D: 128, and 64 at D = 256 (two 128-key K/V stages would not
    fit in shared memory beside Q there)."""
    return BK if D <= 128 else 64


def live_tiles(q_first: int, q_last: int, S: int, causal: bool,
               window: int | None, bk: int = BK) -> range:
    """Kv tiles of ``bk`` keys that some query position in [q_first,
    q_last] sees."""
    hi = -(-S // bk)
    if causal:
        hi = min(hi, q_last // bk + 1)
    lo = 0
    if window is not None:
        lo = max(0, (q_first - window + 1) // bk)
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
    """Plain version of B9: the reference's online softmax, one tile of
    :func:`block_keys` keys at a time, in fp32, GQA by viewing q as (B,
    Hkv, G·T, D)."""
    B, Hq, Hkv, T, S, D = _shape(q, k, v)
    G = Hq // Hkv
    bk = block_keys(D)
    scale = D ** -0.5 if scale is None else scale
    q_offset = S - T
    qf = q.float().reshape(B, Hkv, G * T, D)
    qpos = (torch.arange(T, device=q.device) + q_offset).repeat(G)[:, None]
    m = torch.full((B, Hkv, G * T, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, G * T, D, device=q.device)
    for j in live_tiles(q_offset, S - 1, S, causal, window, bk):
        kb = k[:, :, j * bk:(j + 1) * bk].float()
        vb = v[:, :, j * bk:(j + 1) * bk]
        logits = (qf @ kb.transpose(-1, -2)) * scale
        kpos = torch.arange(j * bk, j * bk + kb.shape[2], device=q.device)
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


# ---------------------------------------------------------------------------
# the training attention: F (forward with its softmax statistics) and N1
# (the backward, N1-dq and N1-dkdv)
# ---------------------------------------------------------------------------
#
# Counterpart of ``repro.models.attention._blocked_flash_core`` (plain JAX
# with a flash-style custom VJP, ``attention.py:112-196``). Its layout is
# the model's: q (B, T, H, dh), k/v (B, S, KV, dh), query t at position
# t + q_offset. Its arithmetic differs from B9's: q is scaled in fp32
# before the dot, p stays fp32 (v is upcast), and the keys are walked in
# ``bk``-key blocks (512 in the model). The softmax statistics m and
# max(l, 1e-30) are (B, H, T) fp32 on both paths.

def train_shape(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                window: int | None, q_offset: int):
    """(B, T, H, S, KV, dh) of a training attention call; raises on a
    shape the kernels do not take and on a call where some query row sees
    no key (the reference's softmax is then not a softmax of any key)."""
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if (k.shape != (B, S, KV, dh) or v.shape != k.shape or H % KV):
        raise ValueError(
            f"flash_attention_train: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}: need q (B, T, H, dh), "
            f"k/v (B, S, KV, dh) with H % KV == 0")
    if q_offset < 0 or (window is not None
                        and (window < 1 or q_offset + T - window >= S)):
        raise ValueError(
            f"flash_attention_train: q_offset={q_offset}, window={window}, "
            f"T={T}, S={S} leave a query row that sees no key")
    del causal
    return B, T, H, S, KV, dh


def _ftype(dtype: torch.dtype) -> torch.dtype:
    """The arithmetic's type: fp32, or fp64 for fp64 inputs (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _penalty(j: int, bk: int, S: int, qpos: Tensor, causal: bool,
             window: int | None, dtype) -> Tensor:
    """The reference's ``_mask_for``: an additive (T, bk) term, 0 where
    attendable and NEG_INF where not (keys past S included)."""
    kpos = (j * bk + torch.arange(bk, device=qpos.device))[None, :]
    mask = kpos <= S - 1
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return torch.where(mask, 0.0, NEG_INF).to(dtype)


def _blocks(k: Tensor, v: Tensor, bk: int):
    """k and v zero-padded to whole ``bk``-key blocks."""
    S = k.shape[1]
    pad = -(-S // bk) * bk - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, (S + pad) // bk


def flash_attention_train_plain(q: Tensor, k: Tensor, v: Tensor, *,
                                causal: bool, window: int | None,
                                q_offset: int, bk: int = 512):
    """Plain version of F: the reference's ``_blocked_flash_fwd`` and
    ``_flash_fwd_scan`` step by step, every ``bk``-key block in order.
    Returns (out in q's dtype, m, max(l, 1e-30)), the statistics
    (B, H, T). m is taken as F takes it (:func:`exact_max_logit`): the
    logit of the first key that holds the row max, again, from its exact
    value rounded once, with l moved onto it, so that m does not depend
    on the order in which this device's product sums over d."""
    B, T, H, S, KV, dh = train_shape(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    G = H // KV
    ft = _ftype(q.dtype)
    qg = q.reshape(B, T, KV, G, dh).to(ft) * dh ** -0.5
    kp, vp, nblk = _blocks(k, v, bk)
    qpos = (torch.arange(T, device=q.device) + q_offset)[:, None]
    acc = torch.zeros(B, T, KV, G, dh, dtype=ft, device=q.device)
    m = torch.full((B, T, KV, G), NEG_INF, dtype=ft, device=q.device)
    l = torch.zeros(B, T, KV, G, dtype=ft, device=q.device)
    arg = torch.zeros(B, T, KV, G, dtype=torch.long, device=q.device)
    for j in range(nblk):
        kblk = kp[:, j * bk:(j + 1) * bk].to(ft)
        vblk = vp[:, j * bk:(j + 1) * bk].to(ft)
        logits = torch.einsum("btkgd,bskd->btkgs", qg, kblk)
        pen = _penalty(j, bk, S, qpos, causal, window, ft)
        logits = logits + pen[None, :, None, None, :]
        top, at = logits.max(-1)          # the first key that holds it
        arg = torch.where(top > m, at + j * bk, arg)
        m_new = torch.maximum(m, top)
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("btkgs,bskd->btkgd", p,
                                                   vblk)
        m = m_new
    lsafe = torch.clamp(l, min=1e-30)
    out = (acc / lsafe[..., None]).reshape(B, T, H, dh).to(q.dtype)
    m_x = exact_max_logit(qg, k, arg).to(ft)
    l_x = torch.clamp(l * torch.exp(m - m_x), min=1e-30)

    def stat(x):
        return x.reshape(B, T, H).transpose(1, 2).contiguous()
    return out, stat(m_x), stat(l_x)


def exact_max_logit(qg: Tensor, k: Tensor, arg: Tensor) -> Tensor:
    """F's m (``csrc/flash_fwd.cu::exact_logit``): the logit of qg (B, T,
    KV, G, dh), q already scaled, and k's row ``arg`` (B, T, KV, G) of its
    kv head, as the products summed in fp64 (each product of two fp32
    values is exact there). Rounded once to fp32 by the caller, it is the
    exact logit rounded to nearest whatever order the fp64 sum takes
    (unless the exact value lies within D·2⁻⁵³·Σ|q_d k_d| of a midpoint of
    two fp32 values), so the kernel and this plain version agree on any
    device, where two fp32 sums need not (fault C-1: at head dim 256 the
    kernel's in-order fp32 chain left m = 0.048 1.13e-5 relative from
    the fp32 plain version's)."""
    B, _, KV = arg.shape[:3]
    b = torch.arange(B, device=k.device)[:, None, None, None]
    kv = torch.arange(KV, device=k.device)[None, None, :, None]
    return (qg.double() * k[b, arg, kv].double()).sum(-1)


def flash_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                              m: Tensor, l: Tensor, dout: Tensor, *,
                              causal: bool, window: int | None,
                              q_offset: int, bk: int = 512):
    """Plain version of N1: the reference's ``_blocked_flash_bwd`` step by
    step over ``bk``-key blocks. m and l (B, H, T) as F returns them.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, T, H, S, KV, dh = train_shape(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    G = H // KV
    ft = _ftype(q.dtype)
    scale = dh ** -0.5
    qg = q.reshape(B, T, KV, G, dh).to(ft) * scale
    og = out.reshape(B, T, KV, G, dh).to(ft)
    dog = dout.reshape(B, T, KV, G, dh).to(ft)
    D = torch.sum(dog * og, dim=-1)                        # (B,T,KV,G)

    def unstat(x):
        return x.to(ft).transpose(1, 2).reshape(B, T, KV, G)
    m5, l5 = unstat(m), unstat(l)
    kp, vp, nblk = _blocks(k, v, bk)
    qpos = (torch.arange(T, device=q.device) + q_offset)[:, None]
    dq = torch.zeros(B, T, KV, G, dh, dtype=ft, device=q.device)
    dks, dvs = [], []
    for j in range(nblk):
        kblk = kp[:, j * bk:(j + 1) * bk].to(ft)
        vblk = vp[:, j * bk:(j + 1) * bk].to(ft)
        logits = torch.einsum("btkgd,bskd->btkgs", qg, kblk)
        pen = _penalty(j, bk, S, qpos, causal, window, ft)
        logits = logits + pen[None, :, None, None, :]
        p = torch.exp(logits - m5[..., None]) / l5[..., None]
        dp = torch.einsum("btkgd,bskd->btkgs", dog, vblk)
        dvs.append(torch.einsum("btkgs,btkgd->bskd", p, dog))
        ds = p * (dp - D[..., None])
        # qg already carries the softmax scale: dlogits/dq = scale * k,
        # dlogits/dk = qg, so dk takes no second scale
        dq = dq + torch.einsum("btkgs,bskd->btkgd", ds, kblk) * scale
        dks.append(torch.einsum("btkgs,btkgd->bskd", ds, qg))
    dk = torch.cat(dks, dim=1)[:, :S]
    dv = torch.cat(dvs, dim=1)[:, :S]
    return (dq.reshape(B, T, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _fp32_aligned(name: str, t: Tensor) -> Tensor:
    if t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the training kernels take contiguous, "
                         f"16-byte aligned fp32 tensors")
    return t


def _train_head_dim(dh: int) -> None:
    if dh not in TRAIN_HEAD_DIMS:
        raise ValueError(f"the training kernels take head dims "
                         f"{TRAIN_HEAD_DIMS}, got {dh}")


def launch_flash_attention_train(q: Tensor, k: Tensor, v: Tensor, *,
                                 causal: bool, window: int | None,
                                 q_offset: int):
    """F on CUDA tensors: q·scale, k and v upcast to fp32, F's two
    kernels launched with scale 1 and a scratch buffer for the split K
    and V tiles; the exact variant when k and v are bf16 or fp16
    (:func:`tf32_exact` of their dtypes). Returns (out in q's dtype, m,
    l)."""
    B, T, H, S, KV, dh = train_shape(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    _train_head_dim(dh)
    exact = tf32_exact(k, v)
    qs = _fp32_aligned("q", (q.float() * dh ** -0.5).contiguous())
    kf = _fp32_aligned("k", k.float().contiguous())
    vf = _fp32_aligned("v", v.float().contiguous())
    out = torch.empty(B, T, H, dh, dtype=torch.float32, device=q.device)
    m = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = _build.library()
    tiles = torch.empty(lib.flash_fwd_scratch(B, KV, S, dh, int(exact)),
                        dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (qs, kf, vf, out)
          for s in t.transpose(1, 2).stride()[:3]))
    with torch.cuda.device(q.device):
        code = lib.flash_attn_fwd_stats(
            *(_build.ptr(t) for t in (qs, kf, vf, out, m, l, tiles)),
            B, H, KV, T, S, dh, strides, 1.0, int(causal),
            0 if window is None else window, q_offset, int(exact),
            _build.stream_handle(q.device))
    _build.check(code, "flash_attention_train")
    return out.to(q.dtype), m, l


def tf32_exact(*ts: Tensor) -> bool:
    """Whether every element of these tensors is exact in TF32 (10
    mantissa bits, fp32's exponent range) by its dtype: bf16 and fp16
    are, so their fp32 upcasts split into a TF32 value and a zero."""
    return all(t.dtype in (torch.bfloat16, torch.float16) for t in ts)


class BwdOperands(NamedTuple):
    """The backward kernels' fp32 operands and whether k, v and dout hold
    TF32-exact values (:func:`tf32_exact` of the tensors they came from),
    so that N1 skips their zero small halves. Made only by
    :func:`bwd_operands`, which reads ``exact`` off the source dtypes."""
    qs: Tensor      # q·scale
    k: Tensor
    v: Tensor
    out: Tensor
    dout: Tensor
    exact: bool


def bwd_operands(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                 dout: Tensor) -> BwdOperands:
    """The backward kernels' operands: q·scale, k, v, out, dout as fp32,
    and ``exact`` from k's, v's and dout's dtypes."""
    scale = q.shape[-1] ** -0.5
    return BwdOperands(*(_fp32_aligned(n, t.contiguous()) for n, t in (
        ("q", q.float() * scale), ("k", k.float()), ("v", v.float()),
        ("out", out.float()), ("dout", dout.float()))),
        exact=tf32_exact(k, v, dout))


def launch_flash_bwd_dq(ops: BwdOperands, m: Tensor, l: Tensor, *,
                        causal: bool, window: int | None, q_offset: int):
    """N1-dq on :func:`bwd_operands`: (dq fp32, D (B, H, T)); the exact
    variant when ``ops.exact``."""
    B, T, H, S, KV, dh = train_shape(ops.qs, ops.k, ops.v, causal=causal,
                                     window=window, q_offset=q_offset)
    _train_head_dim(dh)
    for name, t in (("m", m), ("l", l)):
        _fp32_aligned(name, t)
    dq = torch.empty_like(ops.qs)
    delta = torch.empty(B, H, T, dtype=torch.float32, device=ops.qs.device)
    with torch.cuda.device(ops.qs.device):
        code = _build.library().flash_bwd_dq_f32(
            *(_build.ptr(t) for t in (*ops[:5], m, l, dq, delta)),
            B, T, S, H, KV, dh, q_offset, int(causal),
            0 if window is None else window, dh ** -0.5, int(ops.exact),
            _build.stream_handle(ops.qs.device))
    _build.check(code, "flash_bwd_dq")
    return dq, delta


def launch_flash_bwd_dkdv(ops: BwdOperands, m: Tensor, l: Tensor,
                          delta: Tensor, *, causal: bool,
                          window: int | None, q_offset: int):
    """N1-dkdv on :func:`bwd_operands` and N1-dq's D: (dk, dv) fp32; the
    exact variant when ``ops.exact``. At head dim 256 a kv head's query
    heads are cut into head groups, each a CTA's: their partial sums go to
    a scratch buffer (``flash_bwd_scratch`` floats), which a second kernel
    adds in head-group order."""
    qs, kf, vf, df = ops.qs, ops.k, ops.v, ops.dout
    B, T, H, S, KV, dh = train_shape(qs, kf, vf, causal=causal,
                                     window=window, q_offset=q_offset)
    _train_head_dim(dh)
    for name, t in (("m", m), ("l", l), ("delta", delta)):
        _fp32_aligned(name, t)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    lib = _build.library()
    scratch = torch.empty(lib.flash_bwd_scratch(B, S, H, KV, dh),
                          dtype=torch.float32, device=qs.device)
    with torch.cuda.device(qs.device):
        code = lib.flash_bwd_dkdv_f32(
            *(_build.ptr(t) for t in (qs, kf, vf, df, m, l, delta, dk, dv,
                                      scratch)),
            B, T, S, H, KV, dh, q_offset, int(causal),
            0 if window is None else window, int(ops.exact),
            _build.stream_handle(qs.device))
    if code == -5:
        raise RuntimeError("N1-dkdv: the CUDA driver has no "
                           "cuTensorMapEncodeTiled")
    if code in (-1, -2):
        name, t = (("q", qs), ("dout", df))[-code - 1]
        raise RuntimeError(f"N1-dkdv: cuTensorMapEncodeTiled refused {name} "
                           f"{tuple(t.shape)}")
    _build.check(code, "flash_bwd_dkdv")
    return dk, dv


def flash_attention_train(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                          window: int | None, q_offset: int = 0,
                          bk: int = 512):
    """The training forward: (out, m, l). CPU tensors run the plain
    version over ``bk``-key blocks; CUDA tensors launch F (counted in
    ``flash_attention_train.launches``), which walks its own 32-key tiles
    (``bk`` moves only the plain version's summation order)."""
    if on_cpu(q, k, v, kernel="flash_attention_train"):
        return flash_attention_train_plain(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset,
                                           bk=bk)
    res = launch_flash_attention_train(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    flash_attention_train.launches.bump()
    return res


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                        m: Tensor, l: Tensor, dout: Tensor, *, causal: bool,
                        window: int | None, q_offset: int = 0,
                        bk: int = 512):
    """The training backward: (dq, dk, dv) in q's, k's and v's dtypes.
    CPU tensors run the plain version; CUDA tensors launch N1-dq, then
    N1-dkdv on the same stream (counted in ``.dq_launches``,
    ``launch.flash_bwd_dq``, and ``.dkdv_launches``,
    ``launch.flash_bwd_dkdv``)."""
    args = (q, k, v, out, m, l, dout)
    cpu = on_cpu(*args, kernel="flash_bwd_dq")
    on_cpu(*args, kernel="flash_bwd_dkdv")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if cpu:
        return flash_attention_bwd_plain(*args, bk=bk, **kw)
    ops = bwd_operands(q, k, v, out, dout)
    dq, delta = launch_flash_bwd_dq(ops, m, l, **kw)
    flash_attention_bwd.dq_launches.bump()
    dk, dv = launch_flash_bwd_dkdv(ops, m, l, delta, **kw)
    flash_attention_bwd.dkdv_launches.bump()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_train.launches = _counter("launch.flash_attention_train")
flash_attention_bwd.dq_launches = _counter("launch.flash_bwd_dq")
flash_attention_bwd.dkdv_launches = _counter("launch.flash_bwd_dkdv")
