"""repro_torch.api — the front door of the port (``sodm`` and ``dsvrg`` routes).

    from repro_torch.api import ODMEstimator, ProblemSpec

    est = ODMEstimator(ProblemSpec.create("rbf", gamma=0.5, lam=100.0))
    model, report = est.fit(x, y, 0)          # on the card by default
    acc = est.score(x_test, y_test)
"""
from repro_torch.api import registry
from repro_torch.api.estimator import ODMEstimator
from repro_torch.api.registry import SolverEntry, resolve
from repro_torch.api.report import FitReport
from repro_torch.api.spec import ProblemSpec

__all__ = ["ODMEstimator", "ProblemSpec", "FitReport", "SolverEntry",
           "registry", "resolve"]
