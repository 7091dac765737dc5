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


def on_cpu(*tensors: torch.Tensor) -> bool:
    """The dispatch rule: True → plain version, False → kernel.

    All tensors must share one device type; a mix raises instead of
    silently copying.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(
        f"kernel inputs lie on {sorted(kinds)}: pass all-CPU tensors (plain "
        f"version) or all-CUDA tensors (hand-written kernel)")
