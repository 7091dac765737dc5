"""Versioned, atomic checkpoints with retention.

Port of the synchronous half of ``repro.distributed.checkpoint``, in the
reference's on-disk format, so either package reads the other's steps:

    <dir>/step_<n:010d>/manifest.json + arrays.npz      (committed)
    <dir>/step_<n:010d>.tmp.<pid>/...                   (in flight)

* **Atomic commit**: a step is written into a temp dir, the manifest is
  fsync'd, then the dir is renamed into place; a crash never leaves a
  half-readable step visible.
* **Format 1**: ``arrays.npz`` holds one array per leaf under its path
  (dict keys and sequence indices joined by ``/``); ``manifest.json``
  holds ``step``, ``metadata``, each leaf's shape and dtype, and
  ``format: 1``. A dtype numpy cannot store (bfloat16) is saved as the
  unsigned integer view of its width, with the true dtype in the
  manifest.
* **Retention**: the newest ``keep`` steps stay; older steps and orphaned
  temp dirs are removed after each commit.

Not ported yet (ROADMAP A12): ``save_async`` (the background writer) and
the ``checkpoint.pre_rename`` fault site; both raise. The reference's
elastic re-sharding on restore (``shardings=``) waits for the multi-device
port (A13).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.observe.spans import span as _span

SEP = "/"


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Leaves of nested dicts / lists / tuples under '/'-joined paths (the
    reference's ``tree_flatten_with_path`` keys: dict keys in sorted
    order, sequence indices)."""
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    flat: dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    return flat


def _unflatten_into(template, flat: dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{SEP}{k}" if prefix
                                   else str(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten_into(v, flat, f"{prefix}{SEP}{i}" if prefix
                               else str(i)) for i, v in enumerate(template)]
        return type(template)(out)
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    return flat[prefix]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array numpy can store, and its true dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(
            arr.view(np.int16).copy()).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(np.array(arr))


class CheckpointManager:
    """Atomic, versioned steps under ``directory``; keeps the newest
    ``keep``. ``faults`` (the ``checkpoint.pre_rename`` site) is ROADMAP
    A12 and raises."""

    def __init__(self, directory: str, keep: int = 3, faults=None):
        if faults is not None:
            raise NotImplementedError(
                "the checkpoint.pre_rename fault site is not ported yet "
                "(ROADMAP A12)")
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree, metadata: Optional[dict] = None) -> str:
        """Synchronous checkpoint of a tree of tensors / arrays."""
        with _span("checkpoint.commit", step=step):
            return self._write(step, tree, metadata or {})

    def save_async(self, step: int, tree, metadata: Optional[dict] = None):
        raise NotImplementedError(
            "save_async is not ported yet (ROADMAP A12): use save")

    def _write(self, step: int, tree, metadata: dict) -> str:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + f".tmp.{os.getpid()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        savable, dtypes = {}, {}
        for k, v in _flatten(tree).items():
            savable[k], dtypes[k] = _to_numpy(v)
        np.savez(os.path.join(tmp, "arrays.npz"), **savable)
        manifest = {
            "step": step,
            "metadata": metadata,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in savable.items()},
            "format": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
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
                device=None):
        """Restore into the structure of ``template`` (a tree whose leaves
        are tensors, or anything: only the structure is read). Leaves come
        back as tensors of their saved dtype, exactly, on ``device``
        (default: the CPU)."""
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
        return _unflatten_into(template, flat)
