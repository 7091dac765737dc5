"""Synthetic stand-ins for the paper's 8 LIBSVM data sets (Table 1).

Port of ``repro.data.synthetic``: the same specs (cardinality,
dimensionality, class balance, separation) and the same construction —
two anisotropic Gaussian blobs along a zero-mean class direction, 2%
label noise, features scaled into [0, 1], an 80/20 split — drawn from
``numpy.random.default_rng(seed)``. The numbers differ from the JAX
stream's; the distributions are the same. Arrays come back as float32
CPU tensors; callers move them to their device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    d: int
    balance: float       # fraction of +1
    sep: float           # class separation in feature units (overlap control)


PAPER_DATASETS: dict[str, DatasetSpec] = {
    "gisette": DatasetSpec("gisette", 6_000, 5_000, 0.50, 1.1),
    "svmguide1": DatasetSpec("svmguide1", 7_089, 4, 0.56, 3.0),
    "phishing": DatasetSpec("phishing", 11_055, 68, 0.56, 1.5),
    "a7a": DatasetSpec("a7a", 32_561, 123, 0.24, 1.3),
    "cod-rna": DatasetSpec("cod-rna", 59_535, 8, 0.33, 1.3),
    "ijcnn1": DatasetSpec("ijcnn1", 141_691, 22, 0.10, 1.2),
    "skin-nonskin": DatasetSpec("skin-nonskin", 245_057, 3, 0.21, 1.8),
    "SUSY": DatasetSpec("SUSY", 5_000_000, 18, 0.46, 0.7),
}


class Dataset(NamedTuple):
    x_train: torch.Tensor
    y_train: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor
    name: str


def make_blobs(spec: DatasetSpec, seed: int = 0, scale: float = 1.0,
               max_d: int | None = None) -> Dataset:
    """Two anisotropic Gaussian blobs + label noise, normalized to [0, 1].

    The class direction is zero-mean so the bias-free linear ODM can reach
    the boundary after the [0, 1] shift; a low-rank rotation couples the
    features so the boundary is not axis-aligned.
    """
    n = max(64, int(spec.n * scale))
    n -= n % 8                                     # keep divisible for K
    d = spec.d if max_d is None else min(spec.d, max_d)
    rng = np.random.default_rng(seed)
    n_pos = int(n * spec.balance)
    n_neg = n - n_pos
    u = rng.standard_normal(d)
    u -= u.mean()
    u /= np.linalg.norm(u)
    mix = np.eye(d) + 0.3 * rng.standard_normal((d, d)) / np.sqrt(d)
    xp = rng.standard_normal((n_pos, d)) @ mix + spec.sep * u
    xn = rng.standard_normal((n_neg, d)) @ mix - spec.sep * u
    x = np.concatenate([xp, xn])
    y = np.concatenate([np.ones(n_pos), -np.ones(n_neg)])
    perm = rng.permutation(n)
    x, y = x[perm], y[perm]
    y = np.where(rng.random(n) < 0.02, -y, y)      # 2% label noise
    lo = x.min(axis=0, keepdims=True)
    hi = x.max(axis=0, keepdims=True)
    x = (x - lo) / np.maximum(hi - lo, 1e-9)
    n_tr = int(n * 0.8)
    n_tr -= n_tr % 8
    xt = torch.from_numpy(x.astype(np.float32))
    yt = torch.from_numpy(y.astype(np.float32))
    return Dataset(x_train=xt[:n_tr], y_train=yt[:n_tr], x_test=xt[n_tr:],
                   y_test=yt[n_tr:], name=spec.name)


def load(name: str, seed: int = 0, scale: float = 1.0,
         max_d: int | None = 512) -> Dataset:
    if name not in PAPER_DATASETS:
        raise KeyError(f"unknown dataset {name!r}; one of "
                       f"{list(PAPER_DATASETS)}")
    return make_blobs(PAPER_DATASETS[name], seed=seed, scale=scale,
                      max_d=max_d)
