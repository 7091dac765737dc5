"""Carry state of the JAX package across into the port.

The reference's artifacts and solver results, handed over as numpy
arrays (no import of ``repro`` here), become the port's objects:

* :func:`fitted_from_numpy` builds a :class:`FittedODM`; ``spec`` is
  ``dataclasses.asdict(KernelSpec)`` — the fields the reference's model
  manifest stores (``repro/serve/model.py``, ``FittedODM.save``).
* :func:`sodm_result_from_numpy` builds an :class:`SODMResult`.
* :func:`dsvrg_result_from_numpy` builds a :class:`DSVRGResult`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dsvrg import DSVRGResult
from repro_torch.core.kernel_fns import KernelSpec
from repro_torch.core.sodm import SODMResult
from repro_torch.kernels._device import resolve_device
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
