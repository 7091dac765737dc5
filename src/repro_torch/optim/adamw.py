"""AdamW over parameter trees. Port of ``repro.optim.adamw``.

Pure-function surface as the reference's (``init`` / ``update`` /
``schedule`` / ``global_norm``); ``m`` and ``v`` mirror the parameters
as nested dicts of fp32 tensors (see "Parameter trees" below), so a
checkpoint holds them beside the parameters under the same paths.
``update`` runs in place on the parameters and on m and v (no second
copy of a 0.6B-parameter state on the card) and returns them.

The schedule and the bias corrections are fp32 tensor arithmetic, as
the reference's (``cfg.b1 ** step.astype(f32)``, ``jnp.cos(jnp.pi * t)``
in fp32): Python doubles would move the last bits of every update.
Every leaf takes weight decay, norms and the tied embedding included.

Parameter trees: an LM's parameters are an ``nn.Module`` tree
(``ModuleDict`` / ``ParameterDict`` / ``ModuleList``, built by
``models.model.from_tree``); optimizer state, gradients and codec
residuals mirror it as nested dicts and lists of tensors (what
``distributed.checkpoint`` saves). :func:`as_tree` turns the module into
that form, and :func:`leaves`, :func:`unflatten` and :func:`tree_map`
walk either form in one order, dict keys sorted (as ``jax.tree`` walks
them, whatever order a tree was built in), then list order; the codecs
and the train step share them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch import nn

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def as_tree(x):
    """A parameter module as nested dicts / lists of its parameters;
    dicts, lists and leaves are returned with their modules converted."""
    if isinstance(x, nn.ParameterDict):
        return {k: v for k, v in x.items()}
    if isinstance(x, nn.ModuleDict):
        return {k: as_tree(v) for k, v in x.items()}
    if isinstance(x, nn.ModuleList):
        return [as_tree(v) for v in x]
    if isinstance(x, nn.Module):
        raise TypeError(f"{type(x).__name__} is not a parameter tree")
    if isinstance(x, dict):
        return {k: as_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [as_tree(v) for v in x]
    return x


def leaves(tree) -> list:
    """The tree's leaves in order."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree, values):
    """``values`` (in :func:`leaves` order) in the structure of ``tree``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    out = build(as_tree(tree))
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    cols = [leaves(tree)] + [leaves(t) for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols, strict=True)])


def zeros_f32(tree):
    """fp32 zeros of each leaf's shape, on its device (meta stays meta)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: Tensor        # () int32, on the parameters' device
    m: Any              # fp32 tree mirroring the parameters
    v: Any


def init(params) -> AdamWState:
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros_f32(params), v=zeros_f32(params))


def state_axes(param_axes) -> AdamWState:
    """Logical axes for the state tree (mirrors the parameters')."""
    return AdamWState(step=(), m=param_axes, v=param_axes)


def state_shapes(param_shapes) -> AdamWState:
    """The state as meta tensors (shape and dtype, no storage)."""
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                          device="meta"), param_shapes)
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=meta, v=tree_map(lambda t: t.clone(), meta))


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup then cosine decay to min_lr_frac (fp32)."""
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, state: AdamWState, params, grads):
    """Returns (params, new state, metrics); the parameters and m, v are
    updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, sf)
    b2c = 1.0 - torch.pow(cfg.b2, sf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v), strict=True):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
