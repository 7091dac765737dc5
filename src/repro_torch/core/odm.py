"""Optimal margin Distribution Machine (ODM) — the dual form.

Port of the dual half of ``repro.core.odm`` (the primal half waits for the
dsvrg slice, ROADMAP A9). Dual (paper Eqn. 1/2), alpha = [zeta; beta]:

    min_alpha f(alpha) = 1/2 alpha^T H alpha + b^T alpha
    H = [[Q + M c ups I, -Q], [-Q, Q + M c I]]
    b = [(theta-1) 1_M ; (theta+1) 1_M],   c = (1-theta)^2 / (lam ups)

``mscale`` is the explicit regularizer scale (the "M" multiplying c):
SODM's local subproblems use m = M/K there. Functions taking a cached
``u`` reduce over the last axis, so a leading partition axis batches them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kernel_fns as kf

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ODMParams:
    """Hyperparameters of ODM. ``ups`` is the paper's upsilon (v)."""

    lam: float = 1.0
    theta: float = 0.1
    ups: float = 0.5

    @property
    def c(self) -> float:
        """c = (1-theta)^2 / (lam * ups), constant in the dual Hessian."""
        return (1.0 - self.theta) ** 2 / (self.lam * self.ups)


def split_alpha(alpha: Tensor) -> tuple[Tensor, Tensor]:
    m = alpha.shape[-1] // 2
    return alpha[..., :m], alpha[..., m:]


def dual_objective(Q: Tensor, alpha: Tensor, params: ODMParams,
                   mscale: float) -> Tensor:
    """f(alpha) = 1/2 a^T H a + b^T a with explicit regularizer scale."""
    zeta, beta = split_alpha(alpha)
    gam = zeta - beta
    quad = 0.5 * gam @ (Q @ gam)
    reg = 0.5 * mscale * params.c * (params.ups * zeta @ zeta + beta @ beta)
    lin = (params.theta - 1.0) * torch.sum(zeta) \
        + (params.theta + 1.0) * torch.sum(beta)
    return quad + reg + lin


def dual_grad(Q: Tensor, alpha: Tensor, params: ODMParams,
              mscale: float) -> Tensor:
    """grad f(alpha) = H alpha + b, computed via u = Q (zeta-beta)."""
    zeta, beta = split_alpha(alpha)
    return dual_grad_from_u(Q @ (zeta - beta), alpha, params, mscale)


def dual_grad_from_u(u: Tensor, alpha: Tensor, params: ODMParams,
                     mscale: float) -> Tensor:
    """Gradient given the cached u = Q (zeta - beta)."""
    zeta, beta = split_alpha(alpha)
    gz = u + mscale * params.c * params.ups * zeta + (params.theta - 1.0)
    gb = -u + mscale * params.c * beta + (params.theta + 1.0)
    return torch.cat([gz, gb], dim=-1)


def warm_start_scale(u: Tensor, alpha: Tensor, params: ODMParams,
                     mscale: float) -> Tensor:
    """Optimal scalar t >= 0 for a warm start: argmin_t f(t · alpha).

    f(t·a) = t²·(½ aᵀH a) + t·(bᵀa), so t* = -bᵀa / (aᵀH a), clipped to
    t ≥ 0; t = 1 for a zero (cold) start. Batched over leading axes.
    """
    zeta, beta = split_alpha(alpha)
    gam = zeta - beta
    quad = torch.sum(gam * u, -1) + mscale * params.c * (
        params.ups * torch.sum(zeta * zeta, -1) + torch.sum(beta * beta, -1))
    lin = (params.theta - 1.0) * torch.sum(zeta, -1) \
        + (params.theta + 1.0) * torch.sum(beta, -1)
    return torch.where(quad > 0.0, torch.clamp_min(-lin / quad, 0.0),
                       torch.ones_like(quad))


def hess_diag(q_diag: Tensor, params: ODMParams, mscale: float) -> Tensor:
    """diag(H) = [Q_ii + M c ups; Q_ii + M c]."""
    hz = q_diag + mscale * params.c * params.ups
    hb = q_diag + mscale * params.c
    return torch.cat([hz, hb], dim=-1)


def projected_violation(g: Tensor, alpha: Tensor) -> Tensor:
    """|g| where alpha > 0, max(-g, 0) at the bound alpha = 0."""
    return torch.where(alpha > 0.0, torch.abs(g), torch.clamp_min(-g, 0.0))


def kkt_residual(Q: Tensor, alpha: Tensor, params: ODMParams,
                 mscale: float) -> Tensor:
    """Projected-gradient infinity norm for the box constraint alpha >= 0."""
    g = dual_grad(Q, alpha, params, mscale)
    return torch.max(projected_violation(g, alpha))


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

def decision_function(spec: kf.KernelSpec, x_train: Tensor, y_train: Tensor,
                      alpha: Tensor, x_test: Tensor) -> Tensor:
    """f(x) = sum_i y_i (zeta_i - beta_i) kappa(x_i, x) — dense oracle: it
    materializes the (T, M) test Gram. Served scoring goes through
    :func:`predict` / :mod:`repro_torch.serve`."""
    zeta, beta = split_alpha(alpha)
    coef = y_train * (zeta - beta)
    return kf.gram(spec, x_test, x_train) @ coef


def predict(spec: kf.KernelSpec, x_train: Tensor, y_train: Tensor,
            alpha: Tensor, x_test: Tensor) -> Tensor:
    """Served prediction: compile the dual into a ``FittedODM`` (zeros
    pruned, linear collapsed to w) and score through the tiled scorer."""
    from repro_torch.serve import model as serve_model
    m = serve_model.compile_model(spec, x_train, y_train, alpha)
    return m.predict(x_test)


def accuracy(y_true: Tensor, y_pred: Tensor) -> Tensor:
    return torch.mean(((y_true * y_pred) > 0.0).to(torch.float32))
