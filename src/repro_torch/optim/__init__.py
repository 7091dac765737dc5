"""Optimizers and gradient codecs of the LM training path. Port of
``repro.optim``."""
from repro_torch.optim import adamw, compress, svrg

__all__ = ["adamw", "compress", "svrg"]
