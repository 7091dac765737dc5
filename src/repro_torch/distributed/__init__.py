"""Distributed-systems layer of the port. Port of ``repro.distributed``:
``checkpoint`` (atomic versioned save, restore and async save),
``faults`` (deterministic fault injection), ``resume`` (mid-solve
checkpoints of the level loop and the DSVRG epochs) and ``straggler``
(the speculative partition scheduler) and ``elastic`` (moving state
between device meshes)."""
from repro_torch.distributed import (checkpoint, elastic, faults, resume,
                                     straggler)

__all__ = ["checkpoint", "elastic", "faults", "resume", "straggler"]
