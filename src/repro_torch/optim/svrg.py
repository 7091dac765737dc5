"""SVRG for network training — the paper's Algorithm 2 lifted to LM
heads. Port of ``repro.optim.svrg``.

Exact for the convex last-layer / ODM-head case
(``repro_torch.core.dsvrg`` is the convex implementation); for full
networks the variance-reduction correction g(w) - g(anchor) + h is a
heuristic (non-convexity breaks the theory). The anchor is a copy of the
parameters taken at refresh (the port updates parameters in place, where
the reference's arrays are immutable).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import leaves, tree_map, zeros_f32

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SVRGConfig:
    anchor_every: int = 100      # steps between anchor refreshes
    enabled: bool = False


class SVRGState(NamedTuple):
    anchor_params: Any
    anchor_grad: Any             # h = full gradient at the anchor
    age: Tensor                  # steps since refresh, () int32


def _snapshot(tree):
    return tree_map(lambda p: p.detach().clone(), tree)


def init(params, grads_like) -> SVRGState:
    return SVRGState(anchor_params=_snapshot(params),
                     anchor_grad=zeros_f32(grads_like),
                     age=torch.zeros((), dtype=torch.int32,
                                     device=leaves(params)[0].device))


def refresh(state: SVRGState, params, full_grad) -> SVRGState:
    return SVRGState(anchor_params=_snapshot(params), anchor_grad=full_grad,
                     age=torch.zeros_like(state.age))


def correct(state: SVRGState, grads,
            anchor_batch_grads) -> tuple[Any, SVRGState]:
    """g_vr = g(w) - g(anchor) + h on the same minibatch."""
    out = tree_map(lambda g, ga, h: g - ga + h.to(g.dtype), grads,
                   anchor_batch_grads, state.anchor_grad)
    return out, state._replace(age=state.age + 1)
