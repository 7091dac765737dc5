"""LM substrate: the dense, ssm and hybrid architectures as functions
over parameter modules. Port of ``repro.models`` (``attention``,
``layers``, ``mamba``, ``model``, ``rglru``, ``transformer``; ``moe``
waits for ROADMAP A18)."""
from repro_torch.models import (attention, layers, mamba, model, rglru,
                                transformer)

__all__ = ["attention", "layers", "mamba", "model", "rglru", "transformer"]
