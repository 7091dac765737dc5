"""Logical-axis sharding over ``torch.distributed`` device meshes.

Port of ``repro.sharding``. Every parameter or activation is annotated
with a tuple of *logical* axis names (one per array dim, None for
unsharded). :func:`logical_to_spec` resolves them to a PartitionSpec-like
tuple (:class:`P`) under the active rule set, with the reference's
fallbacks: a mesh axis that is absent, already used by an earlier dim, or
does not divide the dim is dropped, and the dim replicates.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names (``("data",)`` or ``("data", "model")``). The
reference is single-controller (one process, ``shard_map`` splits the
work); the port is SPMD: every rank calls the same entry point with the
same arguments and gets the same replicated result. Resolution reads only
the mesh's axis sizes (:func:`mesh_shape`), so anything whose ``shape``
maps axis names to sizes (the reference's duck-typed test meshes) drives
it too. :func:`spec_to_placements` turns a spec into DTensor placements
(``Shard(d)`` / ``Replicate()`` per mesh dim).

The collectives of the sharded solvers live here, written with
``all_reduce`` and ``broadcast`` only, so the same code runs under
``gloo`` (CPU tensors, or CUDA tensors with two ranks on one card) and
NCCL (one rank a card):

* :func:`psum` — ``all_reduce(SUM)`` over one mesh axis;
* :func:`pmean` — the same, divided by the axis size;
* :func:`all_gather` — the tiled all-gather along dim 0: an ``all_reduce``
  of a zero-filled full buffer in which each rank wrote its rows (exact:
  the fill is −0.0 for floats, and x + (−0.0) = x for every x, signed
  zeros included);
* :func:`broadcast` — from the mesh's first rank to every rank;
* :func:`mesh_all_ok` — a barrier that also agrees on a flag (MIN over
  every mesh dim), so a rank that failed fails the others.

Each counts its calls and payload bytes in the process-wide store of
:mod:`repro_torch.analysis.invariants` as ``collective.<op>`` and
``collective.<op>.bytes``, the way the kernel wrappers count launches,
and opens a host span ``collective.<op>`` (:mod:`repro_torch.observe
.spans`; free when no recorder is installed).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from repro_torch.analysis.invariants import counter as _counter
from repro_torch.observe.spans import span as _span

Tensor = torch.Tensor
Axes = tuple[Any, ...]       # tuple of logical names (str | None) per dim


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    default process group, which the caller has initialised (the world
    size must equal the product of ``shape``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "(gloo on the CPU, nccl on the card) before making a mesh")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": "data",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    "kv_seq": "model",
    "seq": None,
    "layers": None,
    "repeats": None,
    "stack": None,
    "head_dim": None,
    "conv": None,
    "state": None,
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A rule table: logical axis name -> mesh axis, tuple of axes or
    None."""

    rules: Mapping[str, Any] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def replace(self, **kv) -> "ShardingRules":
        r = dict(self.rules)
        r.update(kv)
        return ShardingRules(rules=r)


class P(tuple):
    """A PartitionSpec: per array dim None, one mesh axis name, or a tuple
    of axis names (trailing Nones stripped)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s named dims, or the
    ``shape`` mapping of a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    return dict(mesh.shape)


def logical_to_spec(axes: Axes, shape: Sequence[int], mesh,
                    rules: ShardingRules | None = None) -> P:
    """Resolve logical axes to a spec with the divisibility fallback."""
    rules = rules or ShardingRules()
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, axes):
        mesh_axes = None if name is None else rules.rules.get(name)
        if mesh_axes is None:
            parts.append(None)
            continue
        tup = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
        # only mesh axes that exist on this mesh, are unused so far, and
        # divide the dim
        eff = [a for a in tup if a in sizes and a not in used]
        size = 1
        for a in eff:
            size *= sizes[a]
        if eff and dim % size == 0:
            parts.append(tuple(eff) if len(eff) > 1 else eff[0])
            used.update(eff)
        else:
            parts.append(None)       # divisibility / availability fallback
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def spec_to_placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that shards array dim d, ``Replicate()`` on the others. A
    dim sharded over several mesh axes splits over them in the mesh's
    dim order."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, part in enumerate(spec)
                    if part == name or (isinstance(part, tuple)
                                        and name in part)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to its mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return spec_to_placements(self.spec, self.mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_map_axes(fn, axes_tree, tree):
    """``fn(axes, leaf)`` over an axes tree (dicts, lists and tuples whose
    leaves are logical-axes tuples) and a tree of the same structure."""
    if _is_axes(axes_tree):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, v, tree[k]) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_map_axes(fn, a, t)
                               for a, t in zip(axes_tree, tree))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def _shape(arr) -> tuple:
    return tuple(arr.shape) if hasattr(arr, "shape") else tuple(arr)


def tree_specs(axes_tree, shape_tree, mesh,
               rules: ShardingRules | None = None):
    """A tree of logical-axes tuples + matching shapes (or tensors) -> a
    tree of :class:`P`."""
    return tree_map_axes(
        lambda axes, arr: logical_to_spec(axes, _shape(arr), mesh, rules),
        axes_tree, shape_tree)


def tree_shardings(axes_tree, shape_tree, mesh,
                   rules: ShardingRules | None = None):
    """Same as :func:`tree_specs`, but :class:`NamedSharding` leaves."""
    return tree_map_axes(
        lambda axes, arr: NamedSharding(
            mesh, logical_to_spec(axes, _shape(arr), mesh, rules)),
        axes_tree, shape_tree)


def place(x, mesh, placements):
    """``x`` on ``mesh`` as a ``DTensor`` with ``placements``.

    A plain tensor (the full value, the same on every rank) is moved to
    the mesh's device type and split. A ``DTensor`` on the same mesh is
    redistributed; one on another mesh is first gathered whole
    (``full_tensor()``, a collective of the old mesh) and then
    distributed from the new mesh's first rank, so the ranks that did not
    hold it receive it.
    """
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, placements)
        if x.device_mesh.get_coordinate() is None:   # held none of it
            x = torch.empty(x.shape, dtype=x.dtype)
        else:
            x = x.full_tensor()
    return distribute_tensor(x.to(mesh.device_type), mesh, placements)


# -- active-mesh context ------------------------------------------------------

_ACTIVE: dict = {"mesh": None, "rules": None}


def set_mesh(mesh, rules: ShardingRules | None = None) -> None:
    _ACTIVE["mesh"] = mesh
    _ACTIVE["rules"] = rules


class use_mesh:
    """Context manager: ``with sharding.use_mesh(mesh, rules): ...``"""

    def __init__(self, mesh, rules: ShardingRules | None = None):
        self._new = (mesh, rules)
        self._old = (None, None)

    def __enter__(self):
        self._old = (_ACTIVE["mesh"], _ACTIVE["rules"])
        set_mesh(*self._new)
        return self

    def __exit__(self, *exc):
        set_mesh(*self._old)
        return False


def constrain(x, axes: Axes, rules: ShardingRules | None = None):
    """Place a ``DTensor`` by logical axes on the active mesh. A no-op
    without an active mesh; a plain tensor passes through."""
    from torch.distributed.tensor import DTensor
    mesh = _ACTIVE["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(axes, x.shape, mesh, rules or _ACTIVE["rules"])
    return place(x, mesh, spec_to_placements(spec, mesh))


# -- the collectives of the sharded solvers ----------------------------------

def _collective(op: str, t: Tensor):
    """Count one call of ``op`` with payload ``t``; the returned span
    times the call on the host."""
    nbytes = t.numel() * t.element_size()
    _counter(f"collective.{op}").bump()
    _counter(f"collective.{op}.bytes").bump(nbytes)
    return _span(f"collective.{op}", bytes=nbytes)


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its current card for a CUDA
    mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_mesh_rank0(mesh) -> bool:
    """True on the mesh's first rank (coordinate 0 on every axis)."""
    coord = mesh.get_coordinate()
    return coord is not None and all(c == 0 for c in coord)


def psum(x: Tensor, mesh, axis: str) -> Tensor:
    """Sum of ``x`` over the ranks of ``axis``, on every one of them."""
    import torch.distributed as dist
    out = x.detach().clone()
    with _collective("psum", out):
        dist.all_reduce(out, op=dist.ReduceOp.SUM,
                        group=mesh.get_group(axis))
    return out


def pmean(x: Tensor, mesh, axis: str) -> Tensor:
    """Mean of ``x`` over the ranks of ``axis``: a sum, then a division by
    the axis size."""
    import torch.distributed as dist
    out = x.detach().clone()
    with _collective("pmean", out):
        dist.all_reduce(out, op=dist.ReduceOp.SUM,
                        group=mesh.get_group(axis))
    return out / axis_size(mesh, axis)


def all_gather(x: Tensor, mesh, axis: str) -> Tensor:
    """The tiled all-gather along dim 0: rank r's rows land at
    [r·n, (r+1)·n) of the result on every rank."""
    import torch.distributed as dist
    n, r = x.shape[0], axis_index(mesh, axis)
    buf = x.new_full((axis_size(mesh, axis) * n,) + tuple(x.shape[1:]),
                     -0.0 if x.is_floating_point() else 0)
    buf[r * n:(r + 1) * n] = x
    with _collective("all_gather", buf):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                        group=mesh.get_group(axis))
    return buf


def broadcast(x: Tensor, mesh) -> Tensor:
    """``x`` of the mesh's first rank, on every rank of the mesh (in
    place): one broadcast along each mesh dim in turn."""
    import torch.distributed as dist
    with _collective("broadcast", x):
        for d in range(mesh.ndim):
            group = mesh.get_group(d)
            dist.broadcast(x, src=dist.get_global_rank(group, 0),
                           group=group)
    return x


def mesh_all_ok(mesh, ok: bool) -> bool:
    """A barrier over the whole mesh that returns True only if ``ok`` held
    on every rank."""
    import torch.distributed as dist
    t = torch.tensor([1.0 if ok else 0.0], device=mesh_device(mesh))
    with _collective("barrier", t):
        for d in range(mesh.ndim):
            dist.all_reduce(t, op=dist.ReduceOp.MIN,
                            group=mesh.get_group(d))
    return bool(t.item() > 0.5)
