"""``ProblemSpec`` — the one validated description of an ODM problem.

Port of ``repro.api.spec``: the kernel (:class:`KernelSpec`) and the ODM
hyperparameters (:class:`ODMParams`) in one frozen object, with
hyperparameter checks at construction, data checks at
:meth:`ProblemSpec.validate` and a streaming source's metadata checks at
:meth:`ProblemSpec.validate_source`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kernel_fns as kf
from repro_torch.core.odm import ODMParams

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """A validated (kernel, hyperparameters) pair."""

    kernel: kf.KernelSpec = kf.KernelSpec()
    params: ODMParams = ODMParams()

    def __post_init__(self):
        k, p = self.kernel, self.params
        if k.name not in kf.KERNELS:
            raise ValueError(
                f"kernel must be one of {kf.KERNELS}, got {k.name!r}")
        if k.name in ("rbf", "laplacian", "poly") and not k.gamma > 0.0:
            raise ValueError(
                f"kernel {k.name!r} needs gamma > 0, got {k.gamma}")
        if k.name == "poly" and k.degree < 1:
            raise ValueError(f"poly degree must be >= 1, got {k.degree}")
        if not p.lam > 0.0:
            raise ValueError(f"lam must be > 0, got {p.lam}")
        if not p.ups > 0.0:
            raise ValueError(f"ups must be > 0, got {p.ups}")
        if not 0.0 <= p.theta < 1.0:
            raise ValueError(
                f"theta must be in [0, 1) (c = (1-theta)^2/(lam*ups) "
                f"degenerates at 1), got {p.theta}")

    @classmethod
    def create(cls, kernel: str = "rbf", *, gamma: float = 1.0,
               degree: int = 3, coef0: float = 1.0, lam: float = 1.0,
               theta: float = 0.1, ups: float = 0.5) -> "ProblemSpec":
        """Flat-kwargs convenience constructor."""
        return cls(kernel=kf.KernelSpec(name=kernel, gamma=gamma,
                                        degree=degree, coef0=coef0),
                   params=ODMParams(lam=lam, theta=theta, ups=ups))

    def validate(self, x, y, device: torch.device | None = None
                 ) -> tuple[Tensor, Tensor]:
        """Shape/label checks; returns ``(x, y)`` as float32 tensors on
        ``device`` (default: x's own), labels exactly ±1."""
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
        if x.ndim != 2:
            raise ValueError(f"x must be (M, d), got shape {tuple(x.shape)}")
        if y.ndim != 1:
            raise ValueError(f"y must be (M,), got shape {tuple(y.shape)}")
        if x.shape[0] != y.shape[0]:
            raise ValueError(
                f"x and y disagree on M: {x.shape[0]} vs {y.shape[0]}")
        if x.shape[0] == 0:
            raise ValueError("empty training set")
        bad = int(torch.sum(torch.abs(y) != 1.0))
        if bad:
            raise ValueError(
                f"labels must be exactly +1/-1 (the dual layout and every "
                f"margin formula assume it); {bad} of {y.shape[0]} rows "
                f"are not")
        return x.contiguous(), y.contiguous()

    def validate_source(self, source) -> None:
        """Structural checks for a streaming fit's ShardedSource.

        Metadata only: per-shard label checks happen as shards stream
        through the loader (``iter_slabs``), not here — nobody reads all
        of a source up front.
        """
        n_rows = int(getattr(source, "n_rows"))
        n_features = int(getattr(source, "n_features"))
        if n_rows <= 0:
            raise ValueError(f"empty training source (n_rows={n_rows})")
        if n_features < 1:
            raise ValueError(
                f"source must have >= 1 feature, got {n_features}")
        sizes = tuple(source.shard_sizes())
        if sum(sizes) != n_rows:
            raise ValueError(
                f"source shard sizes sum to {sum(sizes)} but n_rows is "
                f"{n_rows} — the source is inconsistent")
