"""Kernel functions for ODM / SODM.

Port of ``repro.core.kernel_fns``. Plain tensor functions; every Gram
function works on the last two axes, so a leading partition axis
(``(K, m, d)``) is a batch — the port's stand-in for the reference's
``jax.vmap``. The matrix-free tile lowering of every family lives in
:mod:`repro_torch.kernels.gram`.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static description of a positive-definite kernel.

    Attributes:
      name:  one of 'linear' | 'rbf' | 'laplacian' | 'poly'.
      gamma: bandwidth for rbf/laplacian, scale for poly.
      degree: polynomial degree (poly only).
      coef0: polynomial offset (poly only).
    """

    name: str = "rbf"
    gamma: float = 1.0
    degree: int = 3
    coef0: float = 1.0

    def is_shift_invariant(self) -> bool:
        return self.name in ("rbf", "laplacian")

    def family(self) -> str:
        """Accumulation family of the matrix-free Gram lowering: ``"l1"``
        (laplacian) or ``"l2"`` (rbf / poly / linear)."""
        from repro_torch.kernels import gram
        if self.name in gram.L1_KERNELS:
            return "l1"
        if self.name in gram.MATRIX_FREE_KERNELS:
            return "l2"
        raise ValueError(f"no matrix-free lowering for {self.name!r}")

    def diag_value(self) -> float:
        """kappa(x, x) for shift-invariant kernels (the r^2 of Theorem 2)."""
        if self.name in ("rbf", "laplacian"):
            return 1.0
        raise ValueError(f"diag_value undefined for kernel {self.name!r}")


# ---------------------------------------------------------------------------
# pairwise distances / inner products
# ---------------------------------------------------------------------------

def _t(z: Tensor) -> Tensor:
    return z.transpose(-1, -2)


def sq_dists(x: Tensor, z: Tensor) -> Tensor:
    """Pairwise squared euclidean distances (..., m, n), expanded form with
    the cross term as one matmul; tiny negatives from cancellation are
    clamped."""
    xx = torch.sum(x * x, dim=-1)[..., :, None]
    zz = torch.sum(z * z, dim=-1)[..., None, :]
    cross = x @ _t(z)
    return torch.clamp_min(xx + zz - 2.0 * cross, 0.0)


def l1_dists(x: Tensor, z: Tensor) -> Tensor:
    """Pairwise L1 distances (..., m, n); used by laplacian."""
    return torch.cdist(x, z, p=1.0)


# ---------------------------------------------------------------------------
# gram matrices
# ---------------------------------------------------------------------------

def linear_gram(x: Tensor, z: Tensor) -> Tensor:
    return x @ _t(z)


def rbf_gram(x: Tensor, z: Tensor, gamma: float) -> Tensor:
    return torch.exp(-gamma * sq_dists(x, z))


def laplacian_gram(x: Tensor, z: Tensor, gamma: float) -> Tensor:
    return torch.exp(-gamma * l1_dists(x, z))


def poly_gram(x: Tensor, z: Tensor, gamma: float, degree: int,
              coef0: float) -> Tensor:
    return (gamma * (x @ _t(z)) + coef0) ** degree


def gram(spec: KernelSpec, x: Tensor, z: Tensor | None = None) -> Tensor:
    """Gram matrix K[..., i, j] = kappa(x_i, z_j). z defaults to x."""
    z = x if z is None else z
    if spec.name == "linear":
        return linear_gram(x, z)
    if spec.name == "rbf":
        return rbf_gram(x, z, spec.gamma)
    if spec.name == "laplacian":
        return laplacian_gram(x, z, spec.gamma)
    if spec.name == "poly":
        return poly_gram(x, z, spec.gamma, spec.degree, spec.coef0)
    raise ValueError(f"unknown kernel {spec.name!r}")


def gram_diag(spec: KernelSpec, x: Tensor) -> Tensor:
    """diag(K(x, x)) without forming the full gram."""
    if spec.name == "linear":
        return torch.sum(x * x, dim=-1)
    if spec.name in ("rbf", "laplacian"):
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    if spec.name == "poly":
        return (spec.gamma * torch.sum(x * x, dim=-1) + spec.coef0) \
            ** spec.degree
    raise ValueError(f"unknown kernel {spec.name!r}")


def signed_gram(spec: KernelSpec, x: Tensor, y: Tensor,
                xz: Tensor | None = None, yz: Tensor | None = None) -> Tensor:
    """Q[..., i, j] = y_i y_j kappa(x_i, z_j) — the ODM dual Hessian block."""
    xz = x if xz is None else xz
    yz = y if yz is None else yz
    return (y[..., :, None] * yz[..., None, :]) * gram(spec, x, xz)


def median_gamma(x: Tensor, sample: int = 256) -> float:
    """Median-distance heuristic: gamma = 1 / median(||x_i - x_j||^2),
    with the median of an even count taken as the midpoint of the two
    middle values (``jnp.median``'s rule, not ``torch.median``'s)."""
    xs = x[:sample]
    d2 = sq_dists(xs, xs)
    iu = torch.triu_indices(xs.shape[0], xs.shape[0], 1, device=x.device)
    v = torch.sort(d2[iu[0], iu[1]]).values
    n = v.shape[0]
    med = v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])
    return float(1.0 / torch.clamp_min(med, 1e-6))


# Registry used by configs / CLI flags.
KERNELS = ("linear", "rbf", "laplacian", "poly")


def make_spec(name: str, gamma: float = 1.0, degree: int = 3,
              coef0: float = 1.0) -> KernelSpec:
    if name not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {name!r}")
    return KernelSpec(name=name, gamma=gamma, degree=degree, coef0=coef0)
