"""Optimal margin Distribution Machine (ODM) — dual and primal forms.

Port of ``repro.core.odm``. Dual (paper Eqn. 1/2), alpha = [zeta; beta]:

    min_alpha f(alpha) = 1/2 alpha^T H alpha + b^T alpha
    H = [[Q + M c ups I, -Q], [-Q, Q + M c I]]
    b = [(theta-1) 1_M ; (theta+1) 1_M],   c = (1-theta)^2 / (lam ups)

``mscale`` is the explicit regularizer scale (the "M" multiplying c):
SODM's local subproblems use m = M/K there. Functions taking a cached
``u`` reduce over the last axis, so a leading partition axis batches them.

Primal (Section 3.3, linear kernel):

    p(w) = 1/2 ||w||² + lam / (2 M (1-theta)²) Σ_i (xi_i² + ups eps_i²)

with xi_i = max(0, 1-theta-m_i), eps_i = max(0, m_i-1-theta) and margins
m_i = y_i wᵀx_i. These are plain tensor code (the reference's run outside
any Pallas kernel); the fused Hopper forms are
:mod:`repro_torch.kernels.odm_grad`.
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
# primal form (linear kernel)
# ---------------------------------------------------------------------------

def margins(w: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """y_i w^T x_i, shape (M,)."""
    return y * (x @ w)


def _hinge_coef(m: Tensor, y: Tensor, params: ODMParams) -> Tensor:
    """Per-instance quadratic-hinge coefficient s·(lo + ups·hi)·y with the
    per-instance scale s = lam/(1-theta)² (no 1/M: every gradient below
    divides by its own count). Rows with y = 0 (padding) get exactly 0."""
    s = params.lam / (1.0 - params.theta) ** 2
    lo = torch.where(m < 1.0 - params.theta, m + params.theta - 1.0, 0.0)
    hi = torch.where(m > 1.0 + params.theta, m - params.theta - 1.0, 0.0)
    return s * (lo + params.ups * hi) * y


def primal_objective(w: Tensor, x: Tensor, y: Tensor, params: ODMParams,
                     weights: Tensor | None = None,
                     total: int | None = None) -> Tensor:
    """p(w). ``weights`` masks rows (padded rows get 0); ``total`` is the
    true instance count when ``x`` carries padding rows (the loss is
    normalized by it)."""
    m = margins(w, x, y)
    xi = torch.clamp_min((1.0 - params.theta) - m, 0.0)
    eps = torch.clamp_min(m - (1.0 + params.theta), 0.0)
    terms = xi * xi + params.ups * (eps * eps)
    if weights is not None:
        terms = weights * terms
    M = x.shape[0] if total is None else total
    loss = torch.sum(terms) * params.lam / (2.0 * M * (1.0 - params.theta) ** 2)
    return 0.5 * w @ w + loss


def primal_grad(w: Tensor, x: Tensor, y: Tensor, params: ODMParams,
                total: int | None = None) -> Tensor:
    """Full-batch grad p(w), the mean of the per-instance gradients.
    ``total`` is the true count when ``x`` carries padding rows (which
    must have y = 0, so their coefficient is exactly 0)."""
    M = x.shape[0] if total is None else total
    coef = _hinge_coef(margins(w, x, y), y, params)
    return w + (x.T @ coef) / M


def per_instance_grad(w: Tensor, x_i: Tensor, y_i: Tensor,
                      params: ODMParams, M: int) -> Tensor:
    """The paper's unbiased per-instance gradient (Section 3.3). ``M`` is
    accepted for signature parity with :func:`minibatch_grad`, unused."""
    del M
    m = y_i * (x_i @ w)
    return w + _hinge_coef(m, y_i, params) * x_i


def minibatch_grad(w: Tensor, xb: Tensor, yb: Tensor, params: ODMParams,
                   M: int) -> Tensor:
    """Mean of the per-instance gradients over the batch (``M`` unused)."""
    del M
    coef = _hinge_coef(yb * (xb @ w), yb, params)
    return w + (xb.T @ coef) / xb.shape[0]


def svrg_direction(w: Tensor, anchor: Tensor, h: Tensor, xb: Tensor,
                   yb: Tensor, params: ODMParams,
                   wb: Tensor | None = None) -> Tensor:
    """DSVRG inner-step direction g_w − g_a + h on one minibatch:

        (w − anchor + h) + Xᵀ(coef_w − coef_a) / n_valid

    ``wb`` masks ragged-tail padding rows (0: out of the coefficient and
    of the divisor). A leading chain axis batches it: xb (C, B, d), yb
    (C, B) and w (C, d) with ``anchor``, ``h`` and ``wb`` shared."""
    wa = torch.stack([w, anchor.expand_as(w)], dim=-1)      # (..., d, 2)
    mm = yb[..., None] * (xb @ wa)                          # (..., B, 2)
    dcoef = _hinge_coef(mm[..., 0], yb, params) \
        - _hinge_coef(mm[..., 1], yb, params)
    if wb is None:
        n = xb.shape[-2]
    else:
        dcoef = wb * dcoef
        n = torch.clamp_min(torch.sum(wb), 1.0)
    back = (dcoef[..., None, :] @ xb)[..., 0, :]            # Xᵀ dcoef
    return (w - anchor + h) + back / n


# ---------------------------------------------------------------------------
# primal <-> dual bridges and prediction
# ---------------------------------------------------------------------------

def w_from_alpha(x: Tensor, y: Tensor, alpha: Tensor) -> Tensor:
    """KKT: w = X Y (zeta - beta) — linear kernel only."""
    zeta, beta = split_alpha(alpha)
    return x.T @ (y * (zeta - beta))


def alpha_from_w(w: Tensor, x: Tensor, y: Tensor,
                 params: ODMParams) -> Tensor:
    """Inverse KKT map: zeta_i = s·xi_i, beta_i = s·ups·eps_i with
    s = lam/(M(1-theta)²), so w_from_alpha(alpha_from_w(w)) = w exactly
    at a primal stationary point."""
    m = margins(w, x, y)
    xi = torch.clamp_min((1.0 - params.theta) - m, 0.0)
    eps = torch.clamp_min(m - (1.0 + params.theta), 0.0)
    s = params.lam / (x.shape[0] * (1.0 - params.theta) ** 2)
    return torch.cat([s * xi, s * params.ups * eps])


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
