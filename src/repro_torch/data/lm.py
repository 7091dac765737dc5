"""Deterministic synthetic LM token pipeline. Port of ``repro.data.lm``.

Next-token-prediction batches from a seeded Markov-ish stream: tokens
follow a Zipf marginal with a shallow bigram structure (token t + 1 is
biased toward (t · 31 + 7) % V by +2 on its logit), so the loss falls
during training. Each data-parallel rank derives its slice from (seed,
step, rank), so the data cursor is the step counter a checkpoint saves.

The stream is drawn from a ``torch.Generator`` seeded from (seed, step)
on the device asked for; ``jax.random``'s draws cannot be reproduced, so
the tests hold invariants (deterministic per (seed, step), labels the
shifted tokens, in-vocabulary, the Zipf marginal of the first token, the
bigram bias). A draw of categorical(zipf + 2·onehot(b)) is made as the
mixture it is: b with probability π_b = (e² − 1) z_b / (Z + (e² − 1)
z_b), else a Zipf draw (z the Zipf weights, Z their sum). So every Zipf
draw and every mixing uniform of the batch come in one call each (an
inverse-CDF lookup), and only the (B,)-wide recurrence over the S − 1
positions is sequential, where the reference samples S − 1 categoricals
of shape (B, V) in a scan (at V = 151,936 that is never built on the
host).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

from repro_torch.kernels._device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.1


def _zipf_logits(vocab: int, a: float) -> Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
    return -a * torch.log(ranks)


def _generator(cfg: LMDataConfig, step: int, device) -> torch.Generator:
    digest = hashlib.blake2b(f"{cfg.seed}:{step}".encode(),
                             digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest, "little") >> 1)


def batch_at(cfg: LMDataConfig, step: int, device=None) -> dict:
    """The full global batch for a step, on ``device`` (None: the card):
    ``{"tokens", "labels"}``, (B, S) int64, the labels the tokens shifted
    by one with -1 last."""
    dev = resolve_device(device)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    gen = _generator(cfg, step, dev)
    # the law's tables, a (V,) constant: on the host, where cumsum is
    # deterministic (on the card its float scan is not), then copied
    w = torch.exp(_zipf_logits(V, cfg.zipf_a).double())
    cdf = torch.cumsum(w, 0)
    Z = float(cdf[-1])
    lift = (math.e ** 2 - 1.0) * w
    pi = (lift / (Z + lift)).to(dev)    # P(the biased token is drawn)
    cdf = cdf.to(dev)
    u = torch.rand(2, B, S, generator=gen, device=dev, dtype=torch.float64)
    zipf = torch.clamp(torch.searchsorted(cdf, u[0] * Z, right=True),
                       max=V - 1)
    toks = torch.empty(B, S, dtype=torch.int64, device=dev)
    toks[:, 0] = zipf[:, 0]
    for t in range(1, S):
        bias = (toks[:, t - 1] * 31 + 7) % V
        toks[:, t] = torch.where(u[1, :, t] < pi[bias], bias, zipf[:, t])
    labels = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -1)],
                       dim=1)
    return {"tokens": toks, "labels": labels}


def rank_slice(batch: dict, rank: int, n_ranks: int) -> dict:
    """This DP rank's shard of the global batch."""
    def sl(x):
        if x.ndim >= 2 and x.shape[0] % n_ranks == 0:
            per = x.shape[0] // n_ranks
            return x[rank * per:(rank + 1) * per]
        return x
    return {k: sl(v) for k, v in batch.items()}
