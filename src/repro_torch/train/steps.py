"""Serve step builders: the functions the serving launcher calls.

Port of ``repro.train.steps``, serving half: ``make_prefill``,
``make_serve_step``, ``greedy_sample``, ``temperature_sample``. PyTorch
runs eagerly, so a builder returns the plain function (the reference's
launchers jit it). ``TrainConfig``, ``TrainState`` and
``make_train_step`` come with the LM training slice (ROADMAP A17,
second part).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M

Tensor = torch.Tensor


def make_serve_step(cfg: ArchConfig):
    """(params, cache, batch) -> (logits, cache); batch {"tokens" (B, 1),
    "pos" int}."""

    def step(params, cache, batch):
        return M.decode(params, cache, batch["tokens"], batch["pos"], cfg,
                        pos3=batch.get("pos3"))

    return step


def make_prefill(cfg: ArchConfig, max_len: int,
                 attn_impl: str = "flash_pallas"):
    def fn(params, batch):
        return M.prefill(params, batch, cfg, max_len=max_len, impl=attn_impl)
    return fn


def greedy_sample(logits: Tensor) -> Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


def temperature_sample(generator: torch.Generator, logits: Tensor,
                       temp: float = 1.0) -> Tensor:
    """A categorical draw from softmax(logits / temp) per row, from
    ``generator`` (on the logits' device)."""
    probs = torch.softmax(logits[:, -1].float() / temp, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)
