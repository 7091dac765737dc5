"""``FitReport`` — the uniform training report every route returns.

Port of ``repro.api.report`` (pure Python, copied). ``raw`` keeps the
route's native result (e.g. ``SODMResult.perm``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FitReport:
    """What one ``ODMEstimator.fit`` did. ``passes`` holds the sweeps per
    level of the level loop (coarsest level last)."""

    route: str                            # registry route that trained
    engine: str                           # solver engine underneath
    algorithm: str                        # paper algorithm it implements
    n_train: int                          # instances trained on
    n_sv: int                             # SVs in the compiled artifact
    compression: str                      # FittedODM.compression
    wall_clock: float                     # fit seconds (solve + compile)
    passes: tuple[int, ...] = ()          # sweeps per level / (epochs,)
    kkt: float | None = None              # final KKT residual (dual routes)
    eta: float | None = None              # step size used (gradient routes)
    history: tuple[float, ...] | None = None   # per-epoch objective
    gap: float = 0.0                      # compile-time decision gap
    raw: object = None                    # the route's native result

    def summary(self) -> str:
        """One readable line for logs and examples."""
        bits = [f"route={self.route}", f"engine={self.engine}",
                f"M={self.n_train}", f"sv={self.n_sv}",
                f"passes={list(self.passes)}"]
        if self.kkt is not None:
            bits.append(f"kkt={self.kkt:.2e}")
        if self.eta is not None:
            bits.append(f"eta={self.eta:.4g}")
        if self.history:
            bits.append(f"obj={self.history[-1]:.5f}")
        bits.append(f"{self.wall_clock:.2f}s")
        return "FitReport(" + " ".join(bits) + ")"
