"""GQA attention: training (flash_xla: F and N1), prefill (flash, B9) and
cached decode.

Port of ``repro.models.attention``. Three attention impls:

* ``flash_xla`` (the training attention, ``TrainConfig``'s default) —
  :func:`_blocked_flash`, the reference's blocked online softmax with a
  flash-style backward (``attention.py:84-213``), as the custom op
  ``repro_torch::flash_core``: its forward is
  ``kernels.flash_attn.flash_attention_train`` (F on a CUDA tensor, the
  plain version of the reference's ``_blocked_flash_fwd`` on a CPU
  tensor), its backward ``kernels.flash_attn.flash_attention_bwd``
  (N1-dq and N1-dkdv, or the plain version of ``_blocked_flash_bwd``).
  Registered with
  ``torch.library`` so that selective checkpointing
  (``transformer._remat``) sees the core as one op. Queries sit at
  ``arange(T) + q_offset``;
* ``flash_pallas`` (serving's default) — ``kernels.ops.flash_attention``:
  B9 on a CUDA tensor, its plain version on a CPU tensor. B9 has no
  backward, so a call that autograd would differentiate raises (the
  reference's ``jax.grad`` raises there too);
* ``ref`` — ``kernels.ref.mha``, O(T·S), differentiable through plain
  autograd (small shapes and checks only).

The reference's head-sharded ``_flash_sharded`` and its
``sharding.constrain`` pins belong to the LM's mesh path (ROADMAP A17,
third part).

Decode attends a (B, S, kv, dh) static cache, as the reference does:
sliding-window layers keep a ring buffer of W slots. Unlike the
reference's functional update, ``decode_step`` writes the new token's
k/v into the cache tensors in place (a slice copy) and returns the same
tensors. A write position past the cache is clamped to its last
slot, as ``jax.lax.dynamic_update_slice`` clamps it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attn, ops, ref
from repro_torch.models import layers as L

Tensor = torch.Tensor

NEG_INF = -1e30
IMPLS = ("flash_xla", "flash_pallas", "ref")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ArchConfig, dtype,
         cross: bool = False) -> dict:
    """QKV/O projections (+ optional qk-norm scales)."""
    dh = cfg.dh
    p = {"wq": L.dense_init(gen, cfg.d_model, cfg.n_heads * dh, dtype,
                            bias=cfg.qkv_bias),
         "wk": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype,
                            bias=cfg.qkv_bias),
         "wv": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype,
                            bias=cfg.qkv_bias),
         "wo": L.dense_init(gen, cfg.n_heads * dh, cfg.d_model, dtype)}
    if cfg.qk_norm and not cross:
        p["qknorm"] = L.qk_norm_init(dh, dtype, gen.device)
    return p


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_core", mutates_args=())
def _blocked_flash_core(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        window: Optional[int], q_offset: int,
                        bk: int) -> tuple[Tensor, Tensor, Tensor]:
    """The training attention's forward: (out, m, l), m and
    max(l, 1e-30) (B, H, T) fp32 — what the backward re-walks the keys
    from, as the reference's custom VJP saves them."""
    return flash_attn.flash_attention_train(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset,
                                            bk=bk)


def _core_setup(ctx, inputs, output):
    q, k, v, causal, window, q_offset, bk = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.opts = dict(causal=causal, window=window, q_offset=q_offset, bk=bk)


def _core_backward(ctx, dout, dm, dl):
    del dm, dl                  # m and l are statistics, not outputs
    q, k, v, out, m, l = ctx.saved_tensors
    dq, dk, dv = flash_attn.flash_attention_bwd(q, k, v, out, m, l,
                                                dout.contiguous(), **ctx.opts)
    return dq, dk, dv, None, None, None, None


_blocked_flash_core.register_autograd(_core_backward,
                                      setup_context=_core_setup)

#: the core as the dispatcher sees it (what selective checkpointing's
#: policies match)
FLASH_CORE = torch.ops.repro_torch.flash_core.default


def _blocked_flash(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                   window: Optional[int], q_offset: int,
                   bk: int = 512) -> Tensor:
    """The reference's ``_blocked_flash``: q (B, T, H, dh), k/v (B, S, KV,
    dh) -> (B, T, H, dh), differentiable through F's statistics and N1."""
    bk = min(bk, k.shape[1])
    out, _, _ = _blocked_flash_core(q, k, v, causal, window, q_offset, bk)
    return out


def attend(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
           window: Optional[int] = None, q_offset: int = 0,
           impl: str = "flash_pallas") -> Tensor:
    """q (B, T, H, dh); k/v (B, S, KV, dh) -> (B, T, H, dh).

    ``flash_xla`` places the queries at ``arange(T) + q_offset``; B9
    (``flash_pallas``) and ``ref`` place them at the end of the kv
    history (S - T), as the reference's do, and ignore ``q_offset``.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; choose from "
                         f"{IMPLS}")
    if impl == "flash_xla":
        return _blocked_flash(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    if impl == "flash_pallas" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "impl='flash_pallas' (B9) has no backward: autograd would get no "
            "gradient for q, k or v. Train with impl='flash_xla', the "
            "training attention (F forward, N1 backward)")
    fn = ops.flash_attention if impl == "flash_pallas" else ref.mha
    o = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
           causal=causal, window=window)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# layer-level forward (prefill)
# ---------------------------------------------------------------------------

def qkv(p, x: Tensor, cfg: ArchConfig, compute_dtype):
    """x (B, T, D) -> q (B, T, H, dh), k and v (B, T, KV, dh), qk-normed
    where the layer has the scales."""
    B, T, _ = x.shape
    dh = cfg.dh
    q = L.apply_dense(p["wq"], x, compute_dtype).reshape(B, T, cfg.n_heads,
                                                         dh)
    k = L.apply_dense(p["wk"], x, compute_dtype).reshape(B, T,
                                                         cfg.n_kv_heads, dh)
    v = L.apply_dense(p["wv"], x, compute_dtype).reshape(B, T,
                                                         cfg.n_kv_heads, dh)
    if "qknorm" in p:
        q = L.apply_head_rmsnorm(q, p["qknorm"]["q_scale"])
        k = L.apply_head_rmsnorm(k, p["qknorm"]["k_scale"])
    return q, k, v


def rope_qk(q: Tensor, k: Tensor, cfg: ArchConfig, pos: Tensor, pos3):
    """The config's rotary embedding on q and k (M-RoPE raises, A18)."""
    if cfg.rope_kind == "mrope" and pos3 is not None:
        return (L.apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections),
                L.apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections))
    if cfg.rope_kind != "none":
        return (L.apply_rope(q, pos, cfg.rope_theta),
                L.apply_rope(k, pos, cfg.rope_theta))
    return q, k


def forward(p, x: Tensor, cfg: ArchConfig, *, pos: Tensor,
            causal: bool = True, window: Optional[int] = None,
            use_rope: bool = True, pos3: Optional[Tensor] = None,
            memory: Optional[Tensor] = None, impl: str = "flash_pallas",
            compute_dtype=torch.bfloat16) -> Tensor:
    """Full-sequence attention sublayer (no residual/norm — caller owns).
    Cross-attention (``memory``) belongs to the encdec family (A18)."""
    if memory is not None:
        raise NotImplementedError(
            "cross-attention (the encdec family) is not ported yet: "
            "ROADMAP A18")
    B, T, _ = x.shape
    q, k, v = qkv(p, x, cfg, compute_dtype)
    if use_rope:
        q, k = rope_qk(q, k, cfg, pos, pos3)
    o = attend(q, k, v, causal=causal, window=window, impl=impl)
    return L.apply_dense(p["wo"], o.reshape(B, T, cfg.n_heads * cfg.dh),
                         compute_dtype)


# ---------------------------------------------------------------------------
# decode with static caches
# ---------------------------------------------------------------------------

def cache_shape(cfg: ArchConfig, batch: int, max_len: int,
                window: Optional[int] = None, dtype=torch.bfloat16) -> dict:
    """The cache as meta tensors (shape and dtype, no storage): the
    counterpart of the reference's ShapeDtypeStructs."""
    S = max_len if window is None else min(window, max_len)
    shape = (batch, S, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               window: Optional[int] = None, dtype=torch.bfloat16,
               device=None) -> dict:
    """Static KV cache for one layer. Window layers allocate min(W, S)."""
    return {n: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for n, t in cache_shape(cfg, batch, max_len, window,
                                    dtype).items()}


def decode_step(p, cache, x: Tensor, cfg: ArchConfig, *, pos,
                window: Optional[int] = None, use_rope: bool = True,
                pos3: Optional[Tensor] = None,
                compute_dtype=torch.bfloat16):
    """One-token decode. x (B, 1, D); pos the current position (an int or
    a 0-d integer tensor, read on the host).

    Returns (out (B, 1, D), cache): the cache's tensors, updated in place.
    """
    B, T, _ = x.shape
    assert T == 1
    dh = cfg.dh
    pos = int(pos)
    q, k, v = qkv(p, x, cfg, compute_dtype)
    if use_rope:
        pvec = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        q, k = rope_qk(q, k, cfg, pvec, pos3)
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    slot = pos % S if window is not None else pos
    # dynamic_update_slice clamps the start so the update fits; a slice
    # copy needs no index tensor (a host-to-device copy would wait for
    # the stream on every layer)
    i = min(max(slot, 0), S - 1)
    ck[:, i:i + 1].copy_(k)
    cv[:, i:i + 1].copy_(v)
    # masked attend over the whole static cache
    KV = cfg.n_kv_heads
    G = cfg.n_heads // KV
    qg = q.reshape(B, KV, G, dh).float() * dh ** -0.5
    logits = qg @ ck.float().permute(0, 2, 3, 1)          # (B, KV, G, S)
    kpos = torch.arange(S, device=x.device)
    if window is None:
        valid = kpos <= pos
    else:
        # ring buffer: slot i holds the latest position congruent to i;
        # valid iff that position is in (pos - window, pos]
        age = (slot - kpos) % S                          # 0 = newest
        valid = age < min(pos + 1, S)
    logits = torch.where(valid, logits, NEG_INF)
    prob = torch.softmax(logits, dim=-1)
    o = prob @ cv.float().transpose(1, 2)                # (B, KV, G, dh)
    o = o.reshape(B, 1, cfg.n_heads * dh).to(compute_dtype)
    return L.apply_dense(p["wo"], o, compute_dtype), {"k": ck, "v": cv}
