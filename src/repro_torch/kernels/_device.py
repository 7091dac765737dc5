"""Device resolution and the kernel dispatch rule.

Counterpart of ``repro.kernels.ops._INTERPRET`` (``ops.py:27``), which
picks interpret mode from the JAX backend. The port decides per call from
the tensors themselves:

* a CPU tensor goes to the kernel's plain PyTorch version;
* a CUDA tensor goes to the hand-written kernel, which builds or raises;
* anything else (mixed devices, another backend) raises.

Whether a card exists is never consulted here, so a CUDA tensor can never
slip onto a CPU path. Entry points default to the card and raise, naming
``device="cpu"``, when none is present (:func:`resolve_device`).
"""
from __future__ import annotations

import torch

from repro_torch.analysis import launch_lint as _lint


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def on_cpu(*tensors: torch.Tensor, kernel: str | None = None) -> bool:
    """The dispatch rule: True → plain version, False → kernel.

    All tensors must share one device type; a mix raises instead of
    silently copying. ``kernel``: the calling wrapper's name (its
    ``launch.<name>`` counter), given by each public kernel wrapper at
    its one dispatch point; while the launch lint records, the dispatch
    is recorded as a site on either branch.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"cuda"}:
        cpu = kinds == {"cpu"}
        if kernel is not None and _lint.ACTIVE is not None:
            _lint.ACTIVE.kernel(kernel, "cpu" if cpu else "cuda", tensors)
        return cpu
    raise ValueError(
        f"kernel inputs lie on {sorted(kinds)}: pass all-CPU tensors (plain "
        f"version) or all-CUDA tensors (hand-written kernel)")
