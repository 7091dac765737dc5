"""Layer stacks: prefill, decode, forward for the dense, ssm and hybrid
families.

Port of ``repro.models.transformer``. The reference stacks each position
of the layer pattern's repeating unit on a leading "repeats" axis and
runs one ``lax.scan`` over it; here the stack is an ``nn.ModuleList`` of
per-layer parameter trees, walked by a Python loop in the order
``ArchConfig.layer_pattern()`` gives (unit × reps, then the tail:
recurrentgemma's (rec, rec, attn) × 12 + (rec, rec), falcon-mamba's
(ssm,) × 64). The cache is a list with one entry a layer: a ``{"k",
"v"}`` pair of bf16 tensors (B, max_len or the window, KV, dh) for an
attention layer, the recurrent state ``{"h", "conv"}`` (h fp32, the conv
history bf16) for an ``ssm`` (mamba) or ``rec`` (RG-LRU) layer.

Layer kinds: ``"attn"``, ``"ssm"`` (no MLP after it) and ``"rec"``
(followed by the MLP) run; the llama4 iRoPE kinds (``attn_window``,
``attn_global``), mixture-of-experts MLPs and cross-attention raise
``NotImplementedError`` naming ROADMAP A18.

The train-mode :func:`apply_stack` wraps each layer in the reference's
remat policy (``_remat``, ``cfg.remat``): ``none``; ``full`` (every
config's default: ``torch.utils.checkpoint`` around each layer, which
recomputes its forward, the flash forward F included, in the backward);
``dots`` (selective checkpointing that saves the matmuls' outputs,
``checkpoint_dots``); ``attn`` (selective checkpointing that saves only
the attention core's outputs, so the backward recomputes the layer but
never F: the reference's ``save_only_these_names("attn_out")`` and its
aim). Every mode gives the same numbers.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers as L, mamba, rglru

Tensor = torch.Tensor

KINDS = ("attn", "ssm", "rec")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP A18")


def layer_kinds(cfg: ArchConfig) -> list:
    """The stack's layer kinds in order; raises for unported kinds."""
    unit, reps, tail = cfg.layer_pattern()
    kinds = list(unit) * reps + list(tail)
    for kind in kinds:
        if kind not in KINDS:
            raise _unported(f"layer kind {kind!r} (family {cfg.family!r})")
    return kinds


# ---------------------------------------------------------------------------
# single-layer init / apply
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, kind: str, cfg: ArchConfig, dtype,
               cross: bool = False) -> dict:
    """One layer's parameter tree for the given kind."""
    if kind not in KINDS:
        raise _unported(f"layer kind {kind!r}")
    if cross:
        raise _unported("cross-attention (the encdec family)")
    if cfg.moe is not None:
        raise _unported("the mixture-of-experts MLP (the moe family)")
    p = {"ln1": L.norm_init(cfg.d_model, cfg.norm_kind, dtype, gen.device)}
    if kind == "ssm":
        p["ssm"] = mamba.init(gen, cfg, dtype)
        return p                        # mamba block: no separate MLP
    if kind == "rec":
        p["rec"] = rglru.init(gen, cfg, dtype)
    else:
        p["attn"] = attention.init(gen, cfg, dtype)
    p["ln2"] = L.norm_init(cfg.d_model, cfg.norm_kind, dtype, gen.device)
    p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def _kind_attn_opts(kind: str, cfg: ArchConfig):
    """(window, use_rope) per layer kind."""
    if kind == "attn_window":
        return cfg.attn_window, True
    if kind == "attn_global":
        return None, False              # llama4 NoPE global layers
    if kind == "attn" and cfg.rglru is not None:
        return cfg.rglru.window, True   # recurrentgemma local attention
    return None, True


def apply_layer(p, x: Tensor, kind: str, cfg: ArchConfig, *, pos: Tensor,
                pos3: Optional[Tensor] = None,
                memory: Optional[Tensor] = None, causal: bool = True,
                impl: str = "flash_pallas", compute_dtype=torch.bfloat16):
    """Full-sequence layer. Returns (x, aux_loss); aux is 0 (no MoE)."""
    aux = torch.zeros((), device=x.device)
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    if kind == "ssm":
        return x + mamba.forward(p["ssm"], h, cfg, compute_dtype), aux
    if kind == "rec":
        x = x + rglru.forward(p["rec"], h, cfg, compute_dtype)
    else:
        window, use_rope = _kind_attn_opts(kind, cfg)
        x = x + attention.forward(p["attn"], h, cfg, pos=pos, causal=causal,
                                  window=window, use_rope=use_rope,
                                  pos3=pos3, memory=memory, impl=impl,
                                  compute_dtype=compute_dtype)
    h2 = L.apply_norm(p["ln2"], x, cfg.norm_kind)
    x = x + L.apply_mlp(p["mlp"], h2, cfg.act, compute_dtype)
    return x, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def layer_cache_shape(kind: str, cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, cross_len: int = 0) -> dict:
    """One layer's cache as meta tensors: the kv pair of an attention
    layer, the ``{"h", "conv"}`` state of an ssm or rec layer."""
    if kind not in KINDS:
        raise _unported(f"the cache of layer kind {kind!r}")
    if cross_len:
        raise _unported("the cross-attention cache (the encdec family)")
    if kind == "ssm":
        return mamba.state_shape(cfg, batch, dtype)
    if kind == "rec":
        return rglru.state_shape(cfg, batch, dtype)
    window, _ = _kind_attn_opts(kind, cfg)
    return attention.cache_shape(cfg, batch, max_len, window, dtype)


def apply_layer_decode(p, cache, x: Tensor, kind: str, cfg: ArchConfig, *,
                       pos, pos3: Optional[Tensor] = None,
                       compute_dtype=torch.bfloat16):
    """One-token decode through a layer. Returns (x, cache): an attention
    layer's kv cache updated in place, a recurrent layer's new state."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    if kind == "ssm":
        y, cache = mamba.decode_step(p["ssm"], cache, h, cfg, compute_dtype)
        return x + y, cache
    if kind == "rec":
        y, cache = rglru.decode_step(p["rec"], cache, h, cfg, compute_dtype)
    else:
        window, use_rope = _kind_attn_opts(kind, cfg)
        y, cache = attention.decode_step(p["attn"], cache, h, cfg, pos=pos,
                                         window=window, use_rope=use_rope,
                                         pos3=pos3,
                                         compute_dtype=compute_dtype)
    x = x + y
    h2 = L.apply_norm(p["ln2"], x, cfg.norm_kind)
    return x + L.apply_mlp(p["mlp"], h2, cfg.act, compute_dtype), cache


def apply_layer_prefill(p, x: Tensor, kind: str, cfg: ArchConfig, *,
                        pos: Tensor, max_len: int,
                        pos3: Optional[Tensor] = None,
                        memory: Optional[Tensor] = None,
                        impl: str = "flash_pallas",
                        compute_dtype=torch.bfloat16):
    """Full-sequence forward that also emits the layer's decode cache."""
    if memory is not None:
        raise _unported("cross-attention (the encdec family)")
    B, T, _ = x.shape
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    if kind == "ssm":
        ps = p["ssm"]
        xb, xc, z = mamba.in_branches(ps, h, compute_dtype)
        h0 = torch.zeros(B, mamba.d_inner(cfg), cfg.ssm.state,
                         device=x.device)
        y, h_fin = mamba.scan_sequence(ps, xc, cfg, h0)
        out = L.apply_dense(ps["out_proj"], y * F.silu(z),
                            compute_dtype)
        cache = {"h": h_fin, "conv": _tail_pad(xb, cfg.ssm.conv - 1).to(
            torch.bfloat16, copy=True)}
        return x + out, cache
    if kind == "rec":
        pr = p["rec"]
        xb, xc, g = rglru.in_branches(pr, h, compute_dtype)
        hs = rglru.scan(pr, xc)
        out = L.apply_dense(pr["out"], hs.to(compute_dtype) * g,
                            compute_dtype)
        # copies: a view would keep the whole (B, T, .) activation alive
        # in the cache
        cache = {"h": hs[:, -1].clone(), "conv": _tail_pad(
            xb, cfg.rglru.conv - 1).to(torch.bfloat16, copy=True)}
        x = x + out
    else:
        window, use_rope = _kind_attn_opts(kind, cfg)
        q, k, v = attention.qkv(p["attn"], h, cfg, compute_dtype)
        if use_rope:
            q, k = attention.rope_qk(q, k, cfg, pos, pos3)
        o = attention.attend(q, k, v, causal=True, window=window, impl=impl)
        o = o.reshape(B, T, cfg.n_heads * cfg.dh)
        x = x + L.apply_dense(p["attn"]["wo"], o, compute_dtype)
        cache = _fill_kv_cache(k, v, window, max_len)
    h2 = L.apply_norm(p["ln2"], x, cfg.norm_kind)
    x = x + L.apply_mlp(p["mlp"], h2, cfg.act, compute_dtype)
    return x, cache


def _tail_pad(x: Tensor, n: int) -> Tensor:
    """Last n positions of (B, T, d), left-padded with zeros if T < n."""
    T = x.shape[1]
    if T >= n:
        return x[:, T - n:]
    return F.pad(x, (0, 0, n - T, 0))


def _fill_kv_cache(k: Tensor, v: Tensor, window: Optional[int],
                   max_len: int) -> dict:
    """Static cache from prefill kv. k/v (B, T, KV, dh); T <= max_len.

    Global layers: cache size max_len, prompt occupies [0, T).
    Window layers: ring buffer of W slots; slot t%W holds position t for
    the last min(W, T) positions.
    """
    B, T, KV, dh = k.shape
    S = max_len if window is None else min(window, max_len)
    ck = torch.zeros(B, S, KV, dh, dtype=torch.bfloat16, device=k.device)
    cv = torch.zeros_like(ck)
    if window is None:
        ck[:, :T] = k
        cv[:, :T] = v
        return {"k": ck, "v": cv}
    keep = min(S, T)
    # absolute positions of kept entries: [T-keep, T); ring slot = pos % W
    slots = torch.arange(T - keep, T, device=k.device) % S
    ck[:, slots] = k[:, T - keep:].to(torch.bfloat16)
    cv[:, slots] = v[:, T - keep:].to(torch.bfloat16)
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def init_stack(gen: torch.Generator, cfg: ArchConfig, dtype,
               cross: bool = False) -> dict:
    """``{"layers": [layer tree, ...]}`` in ``layer_kinds`` order."""
    return {"layers": [init_layer(gen, kind, cfg, dtype, cross=cross)
                       for kind in layer_kinds(cfg)]}


def _save_only(ops):
    """A selective-checkpoint policy: keep the outputs of ``ops``,
    recompute everything else."""
    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


def _remat(fn, cfg: ArchConfig):
    """``fn`` under the config's remat policy (the reference's
    ``_remat``, ``transformer.py:350``)."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = _save_only({torch.ops.aten.mm.default,
                                       torch.ops.aten.bmm.default,
                                       torch.ops.aten.addmm.default})
    elif cfg.remat == "attn":
        kw["context_fn"] = _save_only({attention.FLASH_CORE})
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def apply_stack(p, x: Tensor, cfg: ArchConfig, *, pos: Tensor,
                pos3: Optional[Tensor] = None,
                memory: Optional[Tensor] = None, causal: bool = True,
                impl: str = "flash_pallas", compute_dtype=torch.bfloat16):
    """Full-sequence stack. Returns (x, total_aux). While autograd
    records, each layer runs under the remat policy."""
    layer = functools.partial(apply_layer, cfg=cfg, pos=pos, pos3=pos3,
                              memory=memory, causal=causal, impl=impl,
                              compute_dtype=compute_dtype)
    if torch.is_grad_enabled():
        layer = _remat(layer, cfg)
    aux = torch.zeros((), device=x.device)
    for lp, kind in zip(p["layers"], layer_kinds(cfg)):
        x, a = layer(lp, x, kind)
        aux = aux + a
    return x, aux


def stack_cache_shape(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, cross_len: int = 0) -> list:
    """Per-layer cache meta tensors, in stack order."""
    return [layer_cache_shape(kind, cfg, batch, max_len, dtype, cross_len)
            for kind in layer_kinds(cfg)]


def apply_stack_decode(p, cache, x: Tensor, cfg: ArchConfig, *, pos,
                       pos3: Optional[Tensor] = None,
                       compute_dtype=torch.bfloat16):
    """One-token decode through the whole stack. Returns (x, cache)."""
    out = []
    for lp, c, kind in zip(p["layers"], cache, layer_kinds(cfg)):
        x, c = apply_layer_decode(lp, c, x, kind, cfg, pos=pos, pos3=pos3,
                                  compute_dtype=compute_dtype)
        out.append(c)
    return x, out


def apply_stack_prefill(p, x: Tensor, cfg: ArchConfig, *, pos: Tensor,
                        max_len: int, pos3: Optional[Tensor] = None,
                        memory: Optional[Tensor] = None,
                        impl: str = "flash_pallas",
                        compute_dtype=torch.bfloat16):
    """Full-sequence prefill producing the per-layer caches."""
    caches = []
    for lp, kind in zip(p["layers"], layer_kinds(cfg)):
        x, c = apply_layer_prefill(lp, x, kind, cfg, pos=pos,
                                   max_len=max_len, pos3=pos3,
                                   memory=memory, impl=impl,
                                   compute_dtype=compute_dtype)
        caches.append(c)
    return x, caches
