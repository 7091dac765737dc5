"""repro_torch.data.lm, the synthetic LM token stream. JAX's draws cannot
be reproduced from a seed, so the stream is held to the reference's own
invariants (``tests/test_train_optim.py::TestLMData``: deterministic,
labels the shifted tokens, in-vocabulary, rank slices partition the
batch) and to the law it samples: the first token follows the Zipf
marginal, and each next token is the bigram target (t · 31 + 7) % V
with the probability the +2 logit gives it, else a Zipf draw."""
import math

import numpy as np
import pytest
import torch

from repro.data import lm as jlm
from repro_torch.data import lm as tlm


def _cfg(**kw):
    base = dict(vocab=128, seq_len=32, global_batch=4)
    base.update(kw)
    return tlm.LMDataConfig(**base)


def test_config_is_the_reference_literal():
    import dataclasses
    assert ([(f.name, f.default) for f in dataclasses.fields(tlm.LMDataConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jlm.LMDataConfig)])


def test_deterministic_per_seed_and_step():
    b1 = tlm.batch_at(_cfg(), 7, device="cpu")
    b2 = tlm.batch_at(_cfg(), 7, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"],
                           tlm.batch_at(_cfg(), 8, device="cpu")["tokens"])
    assert not torch.equal(b1["tokens"], tlm.batch_at(
        _cfg(seed=1), 7, device="cpu")["tokens"])


def test_labels_are_shifted_tokens():
    b = tlm.batch_at(_cfg(), 0, device="cpu")
    assert b["tokens"].dtype == b["labels"].dtype == torch.int64
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert bool((b["labels"][:, -1] == -1).all())


def test_in_vocab():
    b = tlm.batch_at(_cfg(vocab=100, seq_len=16, global_batch=2), 3,
                     device="cpu")
    assert int(b["tokens"].max()) < 100 and int(b["tokens"].min()) >= 0


def test_rank_slices_partition_batch():
    b = tlm.batch_at(_cfg(seq_len=8, global_batch=8), 0, device="cpu")
    whole = torch.cat([tlm.rank_slice(b, r, 4)["tokens"] for r in range(4)])
    assert torch.equal(whole, b["tokens"])
    assert tlm.rank_slice(b, 1, 3)["tokens"] is b["tokens"]


def test_the_stream_follows_the_zipf_bigram_law():
    V, a = 64, 1.1
    b = tlm.batch_at(_cfg(vocab=V, seq_len=64, global_batch=512), 0,
                     device="cpu")["tokens"].numpy()
    w = np.arange(1, V + 1, dtype=np.float64) ** -a
    zipf = w / w.sum()
    # the first token: a Zipf draw (chi-square over the leading ranks,
    # the tail pooled; 8 degrees of freedom, 1e-4 level)
    counts = np.bincount(b[:, 0], minlength=V).astype(np.float64)
    want = zipf * b.shape[0]
    obs = np.append(counts[:8], counts[8:].sum())
    exp = np.append(want[:8], want[8:].sum())
    assert ((obs - exp) ** 2 / exp).sum() < 33.7
    # the next token is the bigram target with the probability of a +2
    # logit on top of the Zipf law
    prev, nxt = b[:, :-1].ravel(), b[:, 1:].ravel()
    target = (prev * 31 + 7) % V
    e2 = math.e ** 2
    p_hit = e2 * zipf[target] / (1.0 + (e2 - 1.0) * zipf[target])
    hits = (nxt == target).astype(np.float64)
    n = hits.size
    assert abs(hits.mean() - p_hit.mean()) < 4 * math.sqrt(
        (p_hit * (1 - p_hit)).sum()) / n
    # ... and otherwise a Zipf draw: the non-target tokens' ranks
    miss = nxt[nxt != target]
    assert np.bincount(miss, minlength=V)[0] > np.bincount(
        miss, minlength=V)[V // 2] * 10


def test_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.batch_at(_cfg(), 0)
