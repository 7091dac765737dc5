"""Architecture registry: ``--arch <id>`` resolution.

``get(name)`` returns the exact published config; ``get_smoke(name)``
returns the reduced same-family config used by CPU smoke tests.

Copy of ``repro.configs.registry`` for the port
(dataclass literals, not imported).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      shape_applicable)

_MODULES = {
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "granite-8b": "repro_torch.configs.granite_8b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
}

ARCH_NAMES = tuple(_MODULES)


def get(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_smoke(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name]).SMOKE


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells():
    """All 40 (arch, shape) cells with their applicability."""
    out = []
    for a in ARCH_NAMES:
        cfg = get(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
