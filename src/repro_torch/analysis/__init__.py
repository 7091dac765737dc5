"""Plan-level accounting of the port. Port of ``repro.analysis``, of
which only the process-wide counter store is ported
(:mod:`repro_torch.analysis.invariants`)."""
from repro_torch.analysis import invariants

__all__ = ["invariants"]
