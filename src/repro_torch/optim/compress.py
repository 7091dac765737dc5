"""Gradient compression with error feedback. Port of
``repro.optim.compress``.

Two codecs, both with error-feedback residual accumulation (the
compression error is added back to the next gradient):

* ``topk`` — keep the k largest-magnitude entries per tensor. Ties go
  to the lower index, as ``jax.lax.top_k`` breaks them: a stable
  descending sort (``torch.topk`` promises no order on ties);
* ``int8`` — per-tensor symmetric int8 quantization (``torch.round``
  rounds half to even, as ``jnp.round`` does).

As in the reference, the codec is applied to the gradient values
(compress -> decompress) before the optimizer, standing in for a
compressed data-parallel all-reduce; the wire saving is analytic
(:func:`wire_ratio`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import leaves, unflatten, zeros_f32

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    codec: str = "none"         # none | topk | int8
    topk_frac: float = 0.01     # fraction of entries kept by topk


class EFState(NamedTuple):
    residual: Any               # fp32 tree mirroring the gradients


def init(grads_shapes) -> EFState:
    return EFState(residual=zeros_f32(grads_shapes))


def _topk_codec(g: Tensor, frac: float) -> Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = torch.sort(torch.abs(flat), descending=True,
                     stable=True).indices[:k]
    mask = torch.zeros_like(flat)
    mask[idx] = 1.0
    return (flat * mask).reshape(g.shape)


def _int8_codec(g: Tensor) -> Tensor:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127)
    return q * scale


def compress(cfg: CompressConfig, state: EFState, grads):
    """Returns (decompressed grads as seen post-all-reduce, new EF
    state)."""
    if cfg.codec == "none":
        return grads, state
    if cfg.codec not in ("topk", "int8"):
        raise ValueError(cfg.codec)
    outs, res = [], []
    for g, r in zip(leaves(grads), leaves(state.residual), strict=True):
        gf = g.float() + r
        out = (_topk_codec(gf, cfg.topk_frac) if cfg.codec == "topk"
               else _int8_codec(gf))
        outs.append(out.to(g.dtype))
        res.append(gf - out)
    return (unflatten(grads, outs),
            EFState(residual=unflatten(state.residual, res)))


def wire_ratio(cfg: CompressConfig) -> float:
    """Bytes-on-wire ratio vs fp32 all-reduce (analytic)."""
    if cfg.codec == "none":
        return 1.0
    if cfg.codec == "topk":
        # values + indices, both 4 bytes
        return 2.0 * cfg.topk_frac
    if cfg.codec == "int8":
        return 0.25
    raise ValueError(cfg.codec)
