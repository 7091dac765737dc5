"""Elastic resharding: move state between meshes without conversion tools.

Port of ``repro.distributed.elastic``. State is always saved as *full
logical arrays* plus logical-axis annotations, never as per-rank shards
with baked-in ranks, so rescaling is re-resolving the placements against
the new mesh:

    old job on a (data=4, model=2) mesh   -> checkpoint
    new job on a (data=2, model=1) mesh   -> restore_elastic(..., mesh)

:func:`reshard` also covers live resharding (tensors already on a mesh):
a leaf on the same mesh is redistributed, a leaf on another mesh is
gathered whole (``full_tensor()``) and distributed from the new mesh's
first rank. The divisibility fallbacks of :mod:`repro_torch.sharding`
make any target mesh safe: a dim that no longer divides replicates.

SPMD: every rank of the meshes involved calls these functions with the
same arguments (they run collectives).
"""
from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch.distributed.checkpoint import _flatten


def reshard(tree, axes_tree, mesh, rules: shd.ShardingRules | None = None):
    """Every leaf on ``mesh`` as a ``DTensor`` with its resolved
    placements."""
    def one(axes, x):
        spec = shd.logical_to_spec(axes, x.shape, mesh, rules)
        return shd.place(x, mesh, shd.spec_to_placements(spec, mesh))
    return shd.tree_map_axes(one, axes_tree, tree)


def restore_elastic(manager, template, axes_tree, mesh, step=None,
                    rules: shd.ShardingRules | None = None):
    """``CheckpointManager.restore`` + placement onto ``mesh`` in one
    call."""
    shardings = shd.tree_shardings(axes_tree, template, mesh, rules)
    return manager.restore(template, step=step, shardings=shardings)


def _full(x) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    t = x.full_tensor() if isinstance(x, DTensor) else torch.as_tensor(x)
    return t.detach().cpu()


def validate_resharding(tree_a, tree_b) -> bool:
    """Value equality of two trees across meshes: the full values of
    every leaf (a ``DTensor`` leaf is gathered, a collective)."""
    la, lb = _flatten(tree_a), _flatten(tree_b)
    return la.keys() == lb.keys() and all(
        torch.equal(_full(la[k]), _full(lb[k])) for k in la)
