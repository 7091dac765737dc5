"""Step builders. Port of ``repro.train``."""
from repro_torch.train import steps

__all__ = ["steps"]
