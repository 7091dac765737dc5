"""Carry state of the JAX package across into the port.

The reference's artifacts and solver results, handed over as numpy
arrays (no import of ``repro`` here), become the port's objects:

* :func:`fitted_from_numpy` builds a :class:`FittedODM`; ``spec`` is
  ``dataclasses.asdict(KernelSpec)`` — the fields the reference's model
  manifest stores (``repro/serve/model.py``, ``FittedODM.save``).
* :func:`sodm_result_from_numpy` builds an :class:`SODMResult`.
* :func:`dsvrg_result_from_numpy` builds a :class:`DSVRGResult`.
* :func:`cascade_result_from_numpy` builds a :class:`CascadeResult`.
* :func:`grad_result_from_numpy` builds a :class:`GradResult` (svrg,
  csvrg).
* :func:`lm_params_from_numpy` builds an LM's parameter module from the
  reference's parameter pytree (``repro.models.model.init_params``).
* :func:`train_state_from_numpy` builds an LM train state (parameters,
  ``AdamWState``, optional ``EFState``) from the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import CascadeResult, GradResult
from repro_torch.core.dsvrg import DSVRGResult
from repro_torch.core.kernel_fns import KernelSpec
from repro_torch.core.sodm import SODMResult
from repro_torch.kernels._device import resolve_device
from repro_torch.models import layers as L, model as M
from repro_torch.serve.model import FittedODM


def _tensor(a, dtype, device) -> torch.Tensor | None:
    if a is None:
        return None
    return torch.as_tensor(np.array(a), dtype=dtype,
                           device=device).contiguous()


def fitted_from_numpy(spec: dict, *, x_sv=None, coef=None, w=None,
                      n_train: int = 0, compression: str = "exact",
                      gap: float = 0.0, device=None) -> FittedODM:
    """A reference ``FittedODM``'s arrays and manifest fields -> the
    port's ``FittedODM`` on ``device`` (None: the card)."""
    dev = resolve_device(device)
    if (w is None) == (x_sv is None or coef is None):
        raise ValueError("give either w, or both x_sv and coef")
    return FittedODM(spec=KernelSpec(**spec),
                     w=_tensor(w, torch.float32, dev),
                     x_sv=_tensor(x_sv, torch.float32, dev),
                     coef=_tensor(coef, torch.float32, dev),
                     n_train=int(n_train), compression=str(compression),
                     gap=float(gap))


def sodm_result_from_numpy(alpha, perm, sweeps_per_level, kkt,
                           device=None) -> SODMResult:
    """A reference ``SODMResult``'s fields -> the port's, on ``device``."""
    dev = resolve_device(device)
    sweeps = [int(s) for s in sweeps_per_level]
    return SODMResult(alpha=_tensor(alpha, torch.float32, dev),
                      perm=_tensor(perm, torch.int64, dev),
                      levels_run=len(sweeps), sweeps_per_level=sweeps,
                      kkt=_tensor(kkt, torch.float32, dev))


def dsvrg_result_from_numpy(w, history, perm, eta,
                            device=None) -> DSVRGResult:
    """A reference ``DSVRGResult``'s fields -> the port's, on ``device``."""
    dev = resolve_device(device)
    return DSVRGResult(w=_tensor(w, torch.float32, dev),
                       history=_tensor(history, torch.float32, dev),
                       perm=_tensor(perm, torch.int64, dev),
                       eta=_tensor(eta, torch.float32, dev))


def cascade_result_from_numpy(x_sv, y_sv, alpha, levels_run,
                              device=None) -> CascadeResult:
    """A reference ``CascadeResult``'s fields -> the port's, on
    ``device``."""
    dev = resolve_device(device)
    return CascadeResult(x_sv=_tensor(x_sv, torch.float32, dev),
                         y_sv=_tensor(y_sv, torch.float32, dev),
                         alpha=_tensor(alpha, torch.float32, dev),
                         levels_run=int(levels_run))


def grad_result_from_numpy(w, history, device=None) -> GradResult:
    """A reference ``GradResult``'s fields -> the port's, on ``device``."""
    dev = resolve_device(device)
    return GradResult(w=_tensor(w, torch.float32, dev),
                      history=_tensor(history, torch.float32, dev))


def lm_params_from_numpy(cfg, params: dict, device=None,
                         trainable: bool = False):
    """The reference's LM parameter pytree, as numpy arrays
    (``{"embed", "stack": {"scan": {"u0": stacked, ...}, "tail": [...]},
    "final_norm", ["unembed"]}``), -> the port's model on ``device``. The
    scan-stacked layers are taken apart in the reference's order: for each
    repeat, the unit's positions in turn, then the tail. ``trainable``
    parameters require grad."""
    M.check_supported(cfg)
    return M.from_tree(_lm_tree(cfg, params, L.dtype_of(cfg.param_dtype),
                                resolve_device(device)), trainable)


def train_state_from_numpy(cfg, state: dict, device=None) -> dict:
    """The reference's LM train state (``repro.train.steps.TrainState``:
    ``{"params", "opt": AdamWState(step, m, v), ["ef": EFState]}``), as
    numpy arrays, -> the port's, on ``device``: trainable parameters, and
    m, v and the EF residual as fp32 trees un-stacked like them."""
    from repro_torch.optim import adamw, compress
    dev = resolve_device(device)
    step, m, v = state["opt"]
    out = {"params": lm_params_from_numpy(cfg, state["params"], dev,
                                          trainable=True),
           "opt": adamw.AdamWState(
               step=torch.as_tensor(np.array(step), dtype=torch.int32,
                                    device=dev),
               m=_lm_tree(cfg, m, torch.float32, dev),
               v=_lm_tree(cfg, v, torch.float32, dev))}
    if "ef" in state:
        (residual,) = state["ef"]
        out["ef"] = compress.EFState(
            residual=_lm_tree(cfg, residual, torch.float32, dev))
    return out


def _lm_tree(cfg, params: dict, dtype, dev) -> dict:
    """A reference LM pytree as the port's nested dicts of ``dtype``
    tensors, the scanned layers un-stacked."""
    def convert(tree, rep=None):
        if isinstance(tree, (list, tuple)):
            return [convert(t, rep) for t in tree]
        if isinstance(tree, dict):
            return {k: convert(v, rep) for k, v in tree.items()}
        a = np.asarray(tree, dtype=np.float32)
        return _tensor(a if rep is None else a[rep], dtype, dev)

    unit, reps, _ = cfg.layer_pattern()
    stack = params["stack"]
    layers = [convert(stack["scan"][f"u{i}"], r) for r in range(reps)
              for i in range(len(unit))] + convert(list(stack["tail"]))
    tree = {k: convert(v) for k, v in params.items() if k != "stack"}
    tree["stack"] = {"layers": layers}
    return tree
