"""Tiled matrix-free decision-function (serving) kernel.

Port of ``repro.kernels.score``. Inference for a kernel expansion is
f(x_t) = Σ_s coef_s kappa(x_s, x_t), a Gram-times-vector product against
the packed support-vector slab — the same computation as
:func:`repro_torch.kernels.gram.gram_matvec` with one partition, request
rows as ``x`` and the SV slab as ``z``.

* :func:`score_tiles`   — on CUDA tensors, K2 (``csrc/gram_matvec.cu``)
  with K = 1, counted in ``score_tiles.launches``; on CPU tensors, its
  plain version :func:`score_blocked`.
* :func:`launch_score`  — the same launch, uncounted, for a caller that
  counts the launches itself: the server captures it into one CUDA graph
  per bucket and bumps ``score_tiles.launches`` on the graph's warm-up
  and on each replay.
* :func:`prepare_slab`  — the SV slab's squared row norms and padded
  features, which the server makes once per model instead of in every
  replay.
* :func:`score_ref`     — dense oracle (materializes (T, S)).
* :func:`score_blocked` — row-block streaming scorer, O(bt·S) memory.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.invariants import counter as _counter
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels._device import on_cpu

Tensor = torch.Tensor


def score_tiles(x: Tensor, z: Tensor, coef: Tensor, *, kind: str = "rbf",
                gamma: float = 1.0, degree: int = 3, coef0: float = 1.0,
                bt: int = 256) -> Tensor:
    """f (T,) = K(x, z) @ coef; ragged shapes are masked in the kernel,
    ``bt`` sizes the plain version's row blocks."""
    if on_cpu(x, z, coef, kernel="score_tiles"):
        return score_blocked(x, z, coef, kind=kind, gamma=gamma,
                             degree=degree, coef0=coef0, bt=bt)
    f = launch_score(x, z, coef, kind=kind, gamma=gamma, degree=degree,
                     coef0=coef0)
    score_tiles.launches.bump()
    return f


def launch_score(x: Tensor, z: Tensor, coef: Tensor, *, kind: str,
                 gamma: float, degree: int, coef0: float,
                 slab: tuple | None = None) -> Tensor:
    """K2 with one partition on CUDA tensors, not counted: the caller
    counts its launches (:func:`score_tiles`, or a captured graph's
    warm-up and replays). ``slab``: :func:`prepare_slab` of z, which the
    launch then reads instead of making it."""
    zz, zp = (None, None) if slab is None else slab
    return gram_mod.launch_gram_matvec(
        x[None].contiguous(), z[None].contiguous(),
        coef.to(torch.float32)[None].contiguous(), kind=kind, gamma=gamma,
        degree=degree, coef0=coef0, zz=zz, zp=zp)[0]


def prepare_slab(z: Tensor, kind: str) -> tuple:
    """(zz, zp) of the (S, d) SV slab as K2 reads it: the squared row
    norms (1, S) for rbf (else None) and the features padded to a multiple
    of 4 (1, S, d4) — the same tensors the launcher makes on each call, so
    a launch given them returns the same bits."""
    z1 = z[None].contiguous()
    zz = gram_mod.row_norms(z1) if kind == "rbf" else None
    return zz, gram_mod.pad_features(z1)


score_tiles.launches = _counter("launch.score_tiles")


def score_ref(x: Tensor, z: Tensor, coef: Tensor, *, kind: str = "rbf",
              gamma: float = 1.0, degree: int = 3,
              coef0: float = 1.0) -> Tensor:
    """Dense oracle: materializes the (T, S) block. Parity target only."""
    k = gram_mod.kernel_tile(kind, x, z, gamma=gamma, degree=degree,
                             coef0=coef0)
    return (k @ coef.to(torch.float32)).to(x.dtype)


def score_blocked(x: Tensor, z: Tensor, coef: Tensor, *, kind: str = "rbf",
                  gamma: float = 1.0, degree: int = 3, coef0: float = 1.0,
                  bt: int = 256) -> Tensor:
    """Streaming scorer over ``bt``-row request chunks: the same numbers as
    :func:`score_ref` with O(bt·S) peak memory."""
    return gram_mod.gram_matvec_plain(
        x[None], z[None], coef.to(torch.float32)[None], kind=kind,
        gamma=gamma, degree=degree, coef0=coef0, bm=bt)[0]
