"""LM substrate: the dense architectures as functions over parameter
modules. Port of ``repro.models`` (``attention``, ``layers``, ``model``,
``transformer``; ``mamba``, ``moe`` and ``rglru`` wait for ROADMAP A18)."""
from repro_torch.models import attention, layers, model, transformer

__all__ = ["attention", "layers", "model", "transformer"]
