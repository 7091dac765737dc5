"""Seeded lint fixture (never imported): device probing, a second library
loader, a kernel library call outside kernels/, a tile literal. One each
of D001, C001, P001, T001."""
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import score


def pick():
    return "cuda" if torch.cuda.is_available() else "cpu"


def load():
    return ctypes.CDLL("librepro_kernels.so")


def smem():
    return _build.library().gram_smem(22)


def scores(x, z, c):
    return score.score_tiles(x, z, c, bt=512)
