"""Architecture configs of the LM scaffold. Port of ``repro.configs``."""
from repro_torch.configs.base import (SHAPES, ArchConfig, EncoderConfig,
                                      MoEConfig, RGLRUConfig, ShapeConfig,
                                      SSMConfig, shape_applicable)
from repro_torch.configs.registry import (ARCH_NAMES, cells, get, get_shape,
                                          get_smoke)

__all__ = ["SHAPES", "ArchConfig", "EncoderConfig", "MoEConfig",
           "RGLRUConfig", "ShapeConfig", "SSMConfig", "shape_applicable",
           "ARCH_NAMES", "cells", "get", "get_shape", "get_smoke"]
