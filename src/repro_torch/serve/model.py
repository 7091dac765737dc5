"""Compiled ODM inference artifacts (the deployable model).

Port of ``repro.serve.model``. The decision function is a kernel
expansion over the dual, f(x) = Σ_i y_i (zeta_i − beta_i) kappa(x_i, x);
:func:`compile_model` turns a dual solution into a :class:`FittedODM`
once:

* **SV pruning** — coefficients with |y·(zeta−beta)| <= ``prune_tol`` are
  dropped and the survivors packed into a contiguous (S, d) slab.
* **Linear collapse** — the linear kernel telescopes to ``w = X_svᵀ coef``.
* **Nyström landmark compression** — the expansion is projected onto
  landmark functions picked by Eqn. 8
  (:func:`repro_torch.core.partition.select_landmarks`); an optional
  ``target`` gap grows the budget geometrically until met.

Scoring goes through :func:`repro_torch.kernels.ops.decision_scores`
(K2 on the card, its streaming plain version on the CPU): never a dense
(T, S) Gram. ``save``/``load_model`` wait for the checkpoint port
(ROADMAP A7).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kernel_fns as kf
from repro_torch.core import odm as odm_mod
from repro_torch.core import partition as part_mod
from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FittedODM:
    """A compiled, deployable ODM model; exactly one representation is
    populated: ``w`` (d,) for the linear kernel, or ``x_sv`` (S, d) +
    ``coef`` (S,). ``compression`` is one of ``"exact" | "pruned" |
    "nystrom" | "linear"``; ``gap`` the estimated max |f_model − f_exact|
    over the compile-time probe set."""

    spec: kf.KernelSpec
    w: Tensor | None = None
    x_sv: Tensor | None = None
    coef: Tensor | None = None
    n_train: int = 0
    compression: str = "exact"
    gap: float = 0.0

    @property
    def n_sv(self) -> int:
        """Support vectors actually scored against (0 for linear w)."""
        return 0 if self.x_sv is None else int(self.x_sv.shape[0])

    @property
    def device(self) -> torch.device:
        return (self.w if self.w is not None else self.x_sv).device

    def decision_function(self, x, *, bt: int = 256,
                          tiled: bool | None = None) -> Tensor:
        """f(x) (T,) on the model's device: x @ w for linear, the tiled
        matrix-free scorer otherwise (``tiled`` as in
        :func:`repro_torch.kernels.ops.decision_scores`)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if self.w is not None:
            return x @ self.w
        return ops.decision_scores(x, self.x_sv, self.coef, self.spec,
                                   bt=bt, tiled=tiled)

    def predict(self, x, **kw) -> Tensor:
        return torch.sign(self.decision_function(x, **kw))

    def save(self, directory: str) -> str:
        raise NotImplementedError(
            "FittedODM.save waits for the checkpoint port (ROADMAP A7)")


# ---------------------------------------------------------------------------
# compilation: solver output -> artifact
# ---------------------------------------------------------------------------

_PROBE_CAP = 512      # decision-gap probe rows (SV subsample)
_JITTER = 1e-8


def compile_model(spec: kf.KernelSpec, x_train: Tensor, y_train: Tensor,
                  alpha: Tensor, *, prune_tol: float = 0.0,
                  budget: int | None = None, target: float | None = None,
                  ) -> FittedODM:
    """Compile a dual solution ``alpha`` (2M,) into a :class:`FittedODM`.
    ``prune_tol = 0.0`` prunes only the exact zeros complementary
    slackness guarantees (lossless); ``budget``/``target`` enable Nyström
    compression of nonlinear kernels."""
    M = x_train.shape[0]
    zeta, beta = odm_mod.split_alpha(alpha)
    coef = y_train * (zeta - beta)
    keep = torch.nonzero(torch.abs(coef) > prune_tol)[:, 0]
    if keep.numel() == 0:
        keep = torch.zeros(1, dtype=torch.int64, device=coef.device)
    x_sv = x_train[keep]
    c_sv = coef[keep]

    if spec.name == "linear":
        w = x_train.T @ coef if prune_tol > 0.0 else x_sv.T @ c_sv
        return FittedODM(spec=spec, w=w, n_train=M, compression="linear")

    n_keep = int(keep.numel())
    compression = "exact" if n_keep == M and prune_tol == 0.0 else "pruned"
    model = FittedODM(spec=spec, x_sv=x_sv.contiguous(),
                      coef=c_sv.contiguous(), n_train=M,
                      compression=compression)
    if prune_tol > 0.0 and n_keep < M:
        probe = x_train[:_PROBE_CAP]
        full = FittedODM(spec=spec, x_sv=x_train, coef=coef, n_train=M)
        model = dataclasses.replace(
            model, gap=decision_gap(model, full, probe))
    if budget is not None and model.n_sv > budget:
        model = compress(model, budget, target=target)
    return model


def from_dsvrg(res) -> FittedODM:
    """A ``DSVRGResult`` is born compressed: linear kernel, explicit w,
    scored as ``x @ w``."""
    return FittedODM(spec=kf.KernelSpec(name="linear"), w=res.w,
                     n_train=int(res.perm.shape[0]), compression="linear")


def from_sodm(spec: kf.KernelSpec, res, x_train: Tensor, y_train: Tensor,
              **kw) -> FittedODM:
    """Compile an ``SODMResult`` — applies ``res.perm`` exactly once."""
    return compile_model(spec, x_train[res.perm], y_train[res.perm],
                         res.alpha, **kw)


# ---------------------------------------------------------------------------
# Nyström landmark compression
# ---------------------------------------------------------------------------

def _nystrom(spec: kf.KernelSpec, x_sv: Tensor, coef: Tensor,
             budget: int) -> tuple[Tensor, Tensor]:
    """Project the expansion onto ``budget`` landmark functions: the
    normal equations K_zz c = K_zs coef, landmarks by Eqn. 8."""
    picks = part_mod.select_landmarks(spec, x_sv, budget)
    z = x_sv[picks]
    kzz = kf.gram(spec, z)
    kzs = kf.gram(spec, z, x_sv)
    eye = torch.eye(budget, dtype=kzz.dtype, device=kzz.device)
    c = torch.linalg.solve(kzz + _JITTER * budget * eye, kzs @ coef)
    return z.contiguous(), c


def decision_gap(model: FittedODM, other: FittedODM, probe: Tensor) -> float:
    """max |f_model(probe) − f_other(probe)| (dense oracle on both sides)."""
    a = model.decision_function(probe, tiled=False)
    b = other.decision_function(probe, tiled=False)
    return float(torch.max(torch.abs(a - b)))


def compress(model: FittedODM, budget: int, *, target: float | None = None,
             probe: Tensor | None = None) -> FittedODM:
    """Nyström-compress an expansion model down to <= ``budget``
    landmarks; with ``target``, double the budget until the gap on
    ``probe`` (default: up to 512 SV rows) is <= target or the budget
    reaches the SV count (then the input model is returned)."""
    if model.x_sv is None:
        return model
    S = model.n_sv
    if budget >= S:
        return model
    if probe is None:
        probe = model.x_sv[:_PROBE_CAP]
    while True:
        z, c = _nystrom(model.spec, model.x_sv, model.coef, budget)
        cand = dataclasses.replace(model, x_sv=z, coef=c,
                                   compression="nystrom")
        gap = decision_gap(cand, model, probe)
        if target is None or gap <= target or budget * 2 >= S:
            break
        budget *= 2
    if target is not None and gap > target and budget * 2 >= S:
        return model
    return dataclasses.replace(cand, gap=model.gap + gap)
