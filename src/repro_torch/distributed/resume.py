"""Mid-solve resume: per-level cascade checkpoints + DSVRG segments.

Port of ``repro.distributed.resume``. The solve state is made durable
through :class:`repro_torch.distributed.checkpoint.CheckpointManager`
(atomic, versioned, retention-managed), so ``fit(resume=dir)`` restarts
a killed level-k solve from the merged level-(k+1) duals instead of from
scratch.

File layout (one resume directory per fit; the reference's)::

    <dir>/step_0000000001/manifest.json   # after the 1st level solve
                          arrays.npz      #   {alphas (K, 2m), perm (M,)}
    <dir>/step_0000000002/...             # after the 2nd, and so on

The manifest metadata carries everything the loop needs to re-enter at
the right place — ``level``/``K``/``m``, the sweeps-per-level history,
the running KKT residual — plus a **provenance** block fingerprinting
(kernel, params, cfg, data, key). Restore refuses (or, with
``strict=False``, warns and cold-starts) when the provenance does not
match. The DSVRG route checkpoints ``{w, history, perm}`` + ``{epoch,
eta}`` between segments (the anchor coincides with ``w`` at every epoch
boundary, so ``w`` alone restarts the next epoch exactly).

Checkpoint steps count completed work (levels solved / epochs run). All
saves are synchronous, as in the reference: a level is coarse-grained
enough that async buys nothing, and a synchronous write is what lets the
``checkpoint.pre_rename`` kill strike on the caller's thread.

Bit-identical guarantee: level solves and DSVRG epochs are deterministic
functions of their inputs on either device (the CUDA kernels reduce in a
fixed order) and the npz round trip is exact, so a resumed fit returns
the same result as the uninterrupted one, with only the not-yet-solved
levels or epochs run again. A resume never crosses devices: the data
fingerprint's ``x_sum``/``y_sum`` are fp32 sums on the fit's device (the
card's reduction order on a CUDA tensor), so a directory written by a fit
on the card need not match the same fit on the CPU — and must not, since
the two devices' solves differ in the last bits.

The *streaming* cascade (``fit(source)``) checkpoints its binary-counter
merge stack after each consumed level-0 leaf (``mode="stream"`` in the
manifest; one ``s{i}_x/s{i}_y/s{i}_alpha`` triple per stack entry, the
tiers and the leaf in the metadata), so a mid-stream kill re-enters at
the first unprocessed shard without reading completed ones again. Dense
level checkpoints and stream leaf checkpoints refuse to resume each
other. A streaming fit's provenance fingerprints the source
(:func:`provenance_source`), not the rows.

On a mesh (the sharded level loop and DSVRG segments) every rank holds
the same replicated state and the same manager: the mesh's first rank
alone commits each checkpoint, while the others visit the same
``checkpoint.pre_rename`` fault site (so a kill there strikes every rank
alike) and wait at a barrier that fails them too if the commit failed;
every rank restores, and no rank leaves the restore before all have read
(a later commit's retention could otherwise remove the step a slower
rank is reading). The solver binds the mesh (:meth:`_Manager.bind`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from typing import NamedTuple

import torch

from repro_torch.distributed.checkpoint import CheckpointManager

Tensor = torch.Tensor


class ProvenanceError(ValueError):
    """Resume directory belongs to a different problem/data/key."""


def _key_fingerprint(key) -> list:
    """The partition key as JSON: an int seed as ``[seed]`` (``None`` is
    seed 0, as the partitioner reads it), a ``torch.Generator`` as the
    sha256 of its state. Take it before the partitioning consumes the
    generator, or a resumed fit's provenance never matches."""
    if isinstance(key, torch.Generator):
        state = key.get_state().numpy().tobytes()
        return ["generator-sha256:" + hashlib.sha256(state).hexdigest()]
    return [0 if key is None else int(key)]


def provenance(kernel, params, cfg, x: Tensor, y: Tensor, key) -> dict:
    """Fingerprint of everything a resumed solve must agree on.

    reprs of the (frozen, nested) config dataclasses are deterministic;
    the data fingerprint is shape/dtype plus two exact fp32 sums on the
    data's device (JSON round-trips binary64 exactly), so a changed
    dataset is caught without hashing O(M·d) bytes.
    """
    return {
        "format": 1,
        "kernel": repr(kernel),
        "params": repr(params),
        "cfg": repr(cfg),
        "data": {
            "shape": [int(s) for s in x.shape],
            "dtype": str(x.dtype).removeprefix("torch."),
            "x_sum": float(torch.sum(x)),
            "y_sum": float(torch.sum(y)),
        },
        "key": _key_fingerprint(key),
    }


def provenance_source(kernel, params, cfg, source, key) -> dict:
    """Streaming-fit provenance: fingerprint the *source*, not the rows.

    A streaming fit never holds the (M, d) matrix, so summing it here
    would defeat the point. ``source.fingerprint()`` is each source's
    own cheap identity (paths + shard sizes for file-backed shards,
    generator seed + shape for synthetic ones, exact float64 sums for
    in-memory arrays, the reference's keys for each).
    """
    return {
        "format": 1,
        "kernel": repr(kernel),
        "params": repr(params),
        "cfg": repr(cfg),
        "data": source.fingerprint(),
        "key": _key_fingerprint(key),
    }


def _check_provenance(saved: dict, want: dict, strict: bool,
                      directory: str) -> bool:
    """True if compatible; raise (strict) or warn+False otherwise."""
    if saved == want:
        return True
    diff = [k for k in want if saved.get(k) != want.get(k)]
    msg = (f"resume directory {directory!r} was written by a different "
           f"run (mismatched: {diff}); refusing to splice its duals into "
           f"this solve")
    if strict:
        raise ProvenanceError(msg)
    warnings.warn(msg + " — cold-starting instead", RuntimeWarning,
                  stacklevel=4)
    return False


@dataclasses.dataclass(frozen=True)
class ResumeConfig:
    """User-facing ``fit(resume=...)`` value (a bare path also works).

    ``segment`` is the DSVRG checkpoint cadence in epochs; the cascade
    route checkpoints every level regardless. ``strict`` controls the
    provenance mismatch behavior (raise vs warn + cold start). ``keep``
    is the checkpoint retention depth — 0 keeps every step.
    """

    directory: str
    keep: int = 3
    strict: bool = True
    segment: int = 1

    @staticmethod
    def of(value) -> "ResumeConfig":
        if isinstance(value, ResumeConfig):
            return value
        return ResumeConfig(directory=os.fspath(value))


class RestoredCascade(NamedTuple):
    level: int               # the level whose solve this state COMPLETED
    K: int
    m: int
    alphas: Tensor           # (K, 2m) post-solve duals of that level
    perm: Tensor             # (M,) partition permutation
    sweeps_per_level: list
    kkt: Tensor


class RestoredStream(NamedTuple):
    leaf: int                # level-0 leaves fully consumed so far
    stack: list              # [(tier, x (m, d), y (m,), alpha (2m,)), ...]


class RestoredSegments(NamedTuple):
    epoch: int               # epochs completed
    w: Tensor
    history: Tensor          # (epoch,) objective after each epoch
    perm: Tensor
    eta: float


class _Manager:
    """The route's checkpoints under ``cfg.directory``, guarded by
    ``prov``."""

    route = ""

    def __init__(self, cfg: ResumeConfig, prov: dict, faults=None):
        self.cfg = cfg
        self.prov = prov
        self.faults = faults
        self.mesh = None
        self.ckpt = CheckpointManager(cfg.directory, keep=cfg.keep,
                                      faults=faults)

    def bind(self, mesh) -> None:
        """Checkpoint as one rank of ``mesh`` (the rank-0-writes rule)."""
        self.mesh = mesh

    def _commit(self, step: int, tree: dict, metadata: dict) -> None:
        if self.mesh is None:
            self.ckpt.save(step, tree, metadata)
            return
        from repro_torch import sharding as shd
        err = None
        try:
            if shd.is_mesh_rank0(self.mesh):
                self.ckpt.save(step, tree, metadata)
            elif self.faults is not None:
                self.faults.site("checkpoint.pre_rename", step=step)
        except BaseException as e:       # raised after the barrier
            err = e
        ok = shd.mesh_all_ok(self.mesh, err is None)
        if err is not None:
            raise err
        if not ok:
            raise RuntimeError(
                f"another rank failed to commit step {step} of "
                f"{self.cfg.directory!r}")

    def _synced(self, restored):
        """Hold every rank of the bound mesh until all have read."""
        if self.mesh is not None:
            from repro_torch import sharding as shd
            shd.mesh_all_ok(self.mesh, True)
        return restored

    def _latest(self, mode: str | None = None):
        """The latest checkpoint's (metadata, manifest, step), or
        ``(None,)*3`` for an empty directory or a lenient provenance
        mismatch. Raises when the directory holds another route's state
        (or, for the cascade, the streaming flavor's)."""
        step = self.ckpt.latest_step()
        if step is None:
            return None, None, None
        manifest = self.ckpt.metadata(step)
        md = manifest["metadata"]
        if md.get("route") != self.route:
            raise ProvenanceError(
                f"resume directory {self.cfg.directory!r} holds "
                f"{md.get('route')!r} checkpoints, not {self.route} state")
        saved_mode = md.get("mode", "level")
        if mode is not None and saved_mode != mode:
            raise ProvenanceError(
                f"resume directory {self.cfg.directory!r} holds cascade "
                f"{saved_mode!r} checkpoints but this fit runs in "
                f"{mode!r} mode — a dense level solve and a streaming "
                f"merge stack cannot resume each other")
        if not _check_provenance(md.get("provenance", {}), self.prov,
                                 self.cfg.strict, self.cfg.directory):
            return None, None, None
        return md, manifest, step

    def _restore_tree(self, manifest: dict, step: int, device) -> dict:
        return self.ckpt.restore(dict.fromkeys(manifest["leaves"]), step,
                                 device=device)


class CascadeResumeManager(_Manager):
    """Per-level checkpoints of the Algorithm-1 level loop."""

    route = "cascade"

    def save_level(self, *, level: int, K: int, m: int, alphas: Tensor,
                   perm: Tensor, sweeps_per_level: list, kkt) -> None:
        step = len(sweeps_per_level)          # levels solved so far
        self._commit(step, {"alphas": alphas, "perm": perm}, {
            "route": self.route,
            "level": int(level), "K": int(K), "m": int(m),
            "sweeps_per_level": [int(s) for s in sweeps_per_level],
            "kkt": float(kkt),
            "provenance": self.prov,
        })

    def restore(self, device=None) -> RestoredCascade | None:
        """The latest level state on ``device`` (None: the CPU), or None
        for a cold start."""
        md, manifest, step = self._latest("level")
        if md is None:
            return self._synced(None)
        tree = self._restore_tree(manifest, step, device)
        alphas = tree["alphas"]
        return self._synced(RestoredCascade(
            level=int(md["level"]), K=int(md["K"]), m=int(md["m"]),
            alphas=alphas, perm=tree["perm"],
            sweeps_per_level=list(md["sweeps_per_level"]),
            kkt=torch.tensor(md["kkt"], dtype=alphas.dtype,
                             device=alphas.device)))

    # -- streaming cascade: merge-stack checkpoints per consumed leaf --------

    def save_stream(self, *, leaf: int, stack) -> None:
        """Checkpoint the binary-counter merge stack after leaf ``leaf``.
        The entries' row counts differ by tier, so each entry is saved
        under its own ``s{i}_*`` keys and the tier list rides in the
        metadata."""
        tree = {}
        for i, (_, xs, ys, alpha) in enumerate(stack):
            tree[f"s{i}_x"] = xs
            tree[f"s{i}_y"] = ys
            tree[f"s{i}_alpha"] = alpha
        self.ckpt.save(leaf, tree, metadata={
            "route": self.route,
            "mode": "stream",
            "leaf": int(leaf),
            "tiers": [int(t) for t, *_ in stack],
            "provenance": self.prov,
        })

    def restore_stream(self, device=None) -> RestoredStream | None:
        """The latest merge stack on ``device`` (None: the CPU), or None
        for a cold start."""
        md, manifest, step = self._latest("stream")
        if md is None:
            return None
        tree = self._restore_tree(manifest, step, device)
        stack = [(int(t), tree[f"s{i}_x"], tree[f"s{i}_y"],
                  tree[f"s{i}_alpha"])
                 for i, t in enumerate(md["tiers"])]
        return RestoredStream(leaf=int(md["leaf"]), stack=stack)


class DsvrgResumeManager(_Manager):
    """Between-segment checkpoints of the Algorithm-2 epochs."""

    route = "dsvrg"

    @property
    def segment(self) -> int:
        return max(1, self.cfg.segment)

    def save_segment(self, *, epoch: int, w: Tensor, history: Tensor,
                     perm: Tensor, eta) -> None:
        self._commit(epoch, {"w": w, "history": history, "perm": perm}, {
            "route": self.route,
            "epoch": int(epoch),
            "eta": float(eta),
            "provenance": self.prov,
        })

    def restore(self, device=None) -> RestoredSegments | None:
        """The latest segment state on ``device`` (None: the CPU), or
        None for a cold start."""
        md, manifest, step = self._latest()
        if md is None:
            return self._synced(None)
        tree = self._restore_tree(manifest, step, device)
        return self._synced(RestoredSegments(
            epoch=int(md["epoch"]), w=tree["w"], history=tree["history"],
            perm=tree["perm"], eta=float(md["eta"])))
