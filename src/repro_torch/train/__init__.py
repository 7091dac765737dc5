"""Step builders. Port of ``repro.train`` (the serving half of ``steps``)."""
from repro_torch.train import steps

__all__ = ["steps"]
