"""Versioned, atomic checkpoints with async write and retention.

Port of ``repro.distributed.checkpoint``, in the reference's on-disk
format, so either package reads the other's steps:

    <dir>/step_<n:010d>/manifest.json + arrays.npz      (committed)
    <dir>/step_<n:010d>.tmp.<pid>/...                   (in flight)

* **Atomic commit**: a step is written into a temp dir, the manifest is
  fsync'd, then the dir is renamed into place; a crash never leaves a
  half-readable step visible. A ``faults`` plan
  (:class:`repro_torch.distributed.faults.FaultPlan`) fires the
  ``checkpoint.pre_rename`` site inside that crash window.
* **Async**: ``save_async`` takes the snapshot to host memory on the
  caller's thread (a ``.cpu()`` copy of every tensor, so a later in-place
  update on the card cannot race the writer) and serializes it on a
  background thread; one write is in flight at a time, and ``wait()``
  joins it and raises again any error the writer met.
* **Format 1**: ``arrays.npz`` holds one array per leaf under its path
  (dict keys, named-tuple field names and sequence indices joined by
  ``/``; an LM's parameter module and a train state's ``AdamWState``
  are trees like any other); ``manifest.json``
  holds ``step``, ``metadata``, each leaf's shape and dtype, and
  ``format: 1``. A dtype numpy cannot store (bfloat16) is saved as the
  unsigned integer view of its width, with the true dtype in the
  manifest.
* **Retention**: the newest ``keep`` steps stay; older steps and orphaned
  temp dirs are removed after each commit.
* **Meshes**: ``save`` of a tree with ``DTensor`` leaves gathers each one
  whole on every rank of its mesh (``full_tensor()``, a collective), and
  only the mesh's first rank writes; the others wait at a barrier that
  also fails them if the write failed. ``restore(shardings=...)`` places
  each leaf on the mesh of its sharding (the elastic path: that mesh may
  differ from the mesh at save time).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.observe.spans import span as _span

SEP = "/"


def _items(tree) -> list | None:
    """A node's (key, child) pairs in the reference's
    ``tree_flatten_with_path`` order — dict keys sorted, named-tuple
    fields by name, sequence indices — or None for a leaf. A parameter
    module (``ParameterDict`` / ``ModuleDict`` / ``ModuleList``, an LM's
    parameter tree) is the dict or list it holds."""
    if isinstance(tree, (nn.ParameterDict, nn.ModuleDict)):
        tree = dict(tree.items())
    elif isinstance(tree, nn.ModuleList):
        tree = list(tree)
    elif isinstance(tree, nn.Module):
        raise TypeError(f"{type(tree).__name__} is not a parameter tree")
    if isinstance(tree, dict):
        return sorted(tree.items(), key=lambda kv: str(kv[0]))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Leaves of nested dicts / lists / tuples / parameter modules under
    '/'-joined paths (:func:`_items`)."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat: dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    return flat


def _unflatten_into(template, flat: dict[str, Any], prefix: str = ""):
    """``template``'s structure with ``flat``'s leaves: a parameter module
    comes back as a new module of its types, each parameter with the
    template's ``requires_grad``."""
    def sub(k):
        return f"{prefix}{SEP}{k}" if prefix else str(k)
    if isinstance(template, nn.ParameterDict):
        return nn.ParameterDict({
            k: nn.Parameter(_unflatten_into(v, flat, sub(k)),
                            requires_grad=v.requires_grad)
            for k, v in template.items()})
    if isinstance(template, nn.ModuleDict):
        # (a models.model.MixedDict holds parameters beside sub-trees)
        return type(template)({
            k: nn.Parameter(_unflatten_into(v, flat, sub(k)),
                            requires_grad=v.requires_grad)
            if isinstance(v, nn.Parameter) else
            _unflatten_into(v, flat, sub(k)) for k, v in template.items()})
    if isinstance(template, nn.ModuleList):
        return nn.ModuleList([_unflatten_into(v, flat, sub(i))
                              for i, v in enumerate(template)])
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, sub(k))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten_into(v, flat, sub(k))
                                for k, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        out = [_unflatten_into(v, flat, sub(i))
               for i, v in enumerate(template)]
        return type(template)(out)
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    return flat[prefix]


def _dtensor_meshes(tree) -> list:
    """The meshes of the tree's ``DTensor`` leaves."""
    from torch.distributed.tensor import DTensor
    return [v.device_mesh for v in _flatten(tree).values()
            if isinstance(v, DTensor)]


def _to_numpy(leaf, copy: bool = False) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array numpy can store, and its true dtype name.
    ``copy``: the array never shares memory with the leaf (a CUDA
    tensor's ``.cpu()`` already is a copy; a CPU tensor's is not). A
    ``DTensor`` leaf is gathered whole first (a collective)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if copy and t.data_ptr() == leaf.data_ptr():
            t = t.clone()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf) if copy else np.asarray(leaf)
    return arr, str(arr.dtype)


def _host(tree, copy: bool = False) -> dict[str, tuple[np.ndarray, str]]:
    """The tree's leaves on the host, by path: ``(array, dtype name)``."""
    return {k: _to_numpy(v, copy) for k, v in _flatten(tree).items()}


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(
            arr.view(np.int16).copy()).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(np.array(arr))


class CheckpointManager:
    """Atomic, versioned steps under ``directory``; keeps the newest
    ``keep`` (0 keeps every step). ``faults``: a fault plan whose
    ``checkpoint.pre_rename`` site fires between the fsync'd temp write
    and the rename."""

    def __init__(self, directory: str, keep: int = 3, faults=None):
        self.dir = directory
        self.keep = keep
        self.faults = faults
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree, metadata: Optional[dict] = None) -> str:
        """Synchronous checkpoint of a tree of tensors / arrays. With
        ``DTensor`` leaves every rank of their mesh calls this; the mesh's
        first rank writes and the others wait for its commit."""
        meshes = _dtensor_meshes(tree)
        host = _host(tree)
        if not meshes:
            return self._write(step, host, metadata or {})
        from repro_torch import sharding as shd
        mesh, err = meshes[0], None
        if shd.is_mesh_rank0(mesh):
            try:
                self._write(step, host, metadata or {})
            except BaseException as e:   # raised after the barrier
                err = e
        ok = shd.mesh_all_ok(mesh, err is None)
        if err is not None:
            raise err
        if not ok:
            raise RuntimeError(
                f"the mesh's first rank failed to commit step {step} "
                f"under {self.dir}")
        return os.path.join(self.dir, f"step_{step:010d}")

    def save_async(self, step: int, tree,
                   metadata: Optional[dict] = None) -> None:
        """Snapshot now (on this thread), serialize in the background.
        ``DTensor`` leaves are refused: their gather is a collective of
        every rank, and only :meth:`save` has the mesh's writer rule."""
        if _dtensor_meshes(tree):
            raise ValueError("save_async takes no DTensor leaves: use save")
        self.wait()                      # one in flight at a time
        host = _host(tree, copy=True)
        md = dict(metadata or {})

        def run():
            try:
                self._write(step, host, md)
            except BaseException as e:   # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise again the error it met."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: dict, metadata: dict) -> str:
        with _span("checkpoint.commit", step=step):
            return self._write_inner(step, host, metadata)

    def _write_inner(self, step: int, host: dict, metadata: dict) -> str:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + f".tmp.{os.getpid()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: arr for k, (arr, _) in host.items()})
        manifest = {
            "step": step,
            "metadata": metadata,
            "leaves": {k: {"shape": list(arr.shape), "dtype": dtype}
                       for k, (arr, dtype) in host.items()},
            "format": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if self.faults is not None:
            # the crash window: a kill here leaves an orphaned temp dir and
            # must not disturb the step committed before it
            self.faults.site("checkpoint.pre_rename", step=step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)
        # temp dirs left by a writer killed before its rename (ours has
        # committed by now)
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp." in name:
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp." not in name:
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metadata(self, step: Optional[int] = None) -> dict:
        """The manifest of ``step`` (default: the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, template, step: Optional[int] = None, *,
                device=None, shardings=None):
        """Restore into the structure of ``template`` (a tree whose leaves
        are tensors, or anything: only the structure is read). Leaves come
        back as tensors of their saved dtype, exactly, on ``device``
        (default: the CPU). ``shardings`` (a tree of
        :class:`repro_torch.sharding.NamedSharding` matching ``template``)
        places each leaf on its mesh as a ``DTensor`` instead — the
        elastic path: the mesh may differ from the mesh at save time.
        Every rank of that mesh calls this."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        manifest = self.metadata(step)
        d = os.path.join(self.dir, f"step_{step:010d}")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: _from_numpy(z[k], manifest["leaves"][k]["dtype"])
                    for k in z.files}
        if device is not None:
            flat = {k: v.to(device) for k, v in flat.items()}
        tree = _unflatten_into(template, flat)
        if shardings is not None:
            from repro_torch import sharding as shd
            tree = _map2(lambda x, s: shd.place(x, s.mesh, s.placements),
                         tree, shardings)
        return tree


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of the same structure."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)
