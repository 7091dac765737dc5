"""Reference attention for ``impl="ref"``.

Port of ``repro.kernels.ref`` — only ``mha`` (``ref.py:111``). The other
oracles of that module are the plain versions that live beside their
kernels in this package (``gram.py``, ``dual_cd_block.py``,
``odm_grad.py``).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def mha(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
        window: int | None = None, scale: float | None = None) -> Tensor:
    """Reference attention. q (B, Hq, T, D), k/v (B, Hkv, S, D).

    GQA: Hq % Hkv == 0; query head h attends to kv head h // (Hq // Hkv).
    window: if set, query position t attends only to kv in
    (t - window, t]. The whole (T, S) logits are formed in the inputs'
    dtype, as the reference's einsums do; memory O(T·S).
    """
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    kq = k.repeat_interleave(group, dim=1)
    vq = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q, kq) * scale
    # positions: queries occupy the last T slots of the S-long history
    qpos = torch.arange(T, device=q.device) + (S - T)
    kpos = torch.arange(S, device=q.device)
    mask = torch.ones(T, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # fully-masked rows give nan; zero them (cannot happen for causal+window>=1)
    probs = torch.nan_to_num(probs)
    return torch.einsum("bhts,bhsd->bhtd", probs, vq)
