"""Top-level model: embeddings + stack + head, for the dense, ssm and
hybrid families.

Port of ``repro.models.model``. Public functions keep the reference's
names and argument order, with the parameter tree ``p`` an ``nn.Module``
(``ModuleDict``/``ParameterDict``/``ModuleList`` keyed as the
reference's pytree, the stack's layers un-stacked):

  init_params(cfg, *, generator, device, trainable) -> model
  logits_fn(p, batch, cfg)                -> (logits, aux)
  loss_fn(p, batch, cfg)                  -> (loss, metrics)  [train step]
  prefill(p, batch, cfg, *, max_len)      -> (last_logits, cache)
  decode(p, cache, tok, pos, cfg)         -> (logits, cache)
  cache_shapes(cfg, batch, max_len)       -> per-layer meta tensors

``impl`` defaults to ``"flash_pallas"`` (B9 on the card) for serving;
training passes ``"flash_xla"`` (``TrainConfig.attn_impl``). The dense,
ssm (falcon-mamba) and hybrid (recurrentgemma: RG-LRU and local
attention) families are built, served and trained. The moe, encdec and vlm
families, M-RoPE and llama4's iRoPE window/global layers wait for A18
and raise when a model is built from them (``check_supported``). ``param_shapes``, ``input_specs`` and
``batch_axes`` serve the TPU dry-run (A19) and the LM's mesh path
(A17, third part).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._device import resolve_device
from repro_torch.models import layers as L, transformer as T

Tensor = torch.Tensor


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what this slice does not run, naming its ROADMAP item."""
    for what, unported in (
            (f"the {cfg.family} family",
             cfg.family not in ("dense", "ssm", "hybrid")),
            ("mixture-of-experts MLPs", cfg.moe is not None),
            ("M-RoPE", cfg.rope_kind == "mrope"),
            ("the encoder stack", cfg.encoder is not None),
            ("attn_window / global_every (iRoPE) layers",
             cfg.attn_window is not None or cfg.global_every > 1)):
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet: ROADMAP A18 (the "
                f"port builds the dense, ssm and hybrid families only)")
    T.layer_kinds(cfg)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

class MixedDict(nn.ModuleDict):
    """A tree node that holds parameters beside sub-trees (mamba's
    ``A_log`` and ``D`` beside its projections): a ``ModuleDict`` whose
    items, keys and ``[]`` cover both, in the reference's key order."""

    def __init__(self, children: dict):
        super().__init__()
        self._order = list(children)
        for k, v in children.items():
            if isinstance(v, nn.Parameter):
                self.register_parameter(k, v)
            else:
                self.add_module(k, v)

    def __getitem__(self, key):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def __contains__(self, key) -> bool:
        return key in self._order

    def __iter__(self):
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def keys(self):
        return list(self._order)

    def items(self):
        return [(k, self[k]) for k in self._order]

    def values(self):
        return [self[k] for k in self._order]


def from_tree(tree, trainable: bool = False) -> nn.Module:
    """A nested dict/list of tensors (the reference's pytree layout) as an
    ``nn.Module``; its parameters require grad only if ``trainable``
    (serving keeps them frozen)."""
    if isinstance(tree, list):
        return nn.ModuleList([from_tree(t, trainable) for t in tree])
    leaf = {k: isinstance(v, Tensor) for k, v in tree.items()}
    if all(leaf.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=trainable)
                                 for k, v in tree.items()})
    if any(leaf.values()):
        return MixedDict({k: nn.Parameter(v, requires_grad=trainable)
                          if leaf[k] else from_tree(v, trainable)
                          for k, v in tree.items()})
    return nn.ModuleDict({k: from_tree(v, trainable)
                          for k, v in tree.items()})


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                device=None, trainable: bool = False) -> nn.Module:
    """Random weights with the reference's distributions: normal ·
    in_dim^-0.5 for projections, normal · d^-0.5 for the embedding, ones
    for norm scales (zeros for biases). Drawn on ``generator``'s device,
    then moved to ``device`` (None: the card); ``trainable`` parameters
    require grad."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = L.dtype_of(cfg.param_dtype)
    gen = generator
    tree = {"embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
            "stack": T.init_stack(gen, cfg, dtype),
            "final_norm": L.norm_init(cfg.d_model, cfg.norm_kind, dtype,
                                      gen.device)}
    if not cfg.tie_embeddings:
        tree["unembed"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       dtype)
    return from_tree(tree, trainable).to(dev)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return L.dtype_of(cfg.compute_dtype)


def _positions(B: int, S: int, device) -> Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _head(p, x: Tensor, cfg: ArchConfig, cdt) -> Tensor:
    if cfg.tie_embeddings:
        return L.apply_unembed(p["embed"], x, cdt)
    return L.apply_dense(p["unembed"], x, cdt)


def logits_fn(p, batch: dict, cfg: ArchConfig, *,
              impl: str = "flash_pallas"):
    """Full-sequence logits (B, S, padded_vocab) + aux loss (0)."""
    cdt = _compute_dtype(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.apply_embed(p["embed"], tokens, cdt)
    x, aux = T.apply_stack(p["stack"], x, cfg,
                           pos=_positions(B, S, tokens.device),
                           pos3=batch.get("pos3"), impl=impl,
                           compute_dtype=cdt)
    x = L.apply_norm(p["final_norm"], x, cfg.norm_kind)
    return _head(p, x, cfg, cdt), aux


def loss_fn(p, batch: dict, cfg: ArchConfig, *, impl: str = "flash_xla",
            aux_weight: float = 0.01):
    """Causal-LM cross entropy in fp32 (+ aux, 0 without MoE). Returns
    (loss, metrics {nll, aux, ppl_proxy}); labels < 0 are masked.

    The gold logit is a ``torch.gather``, where the reference contracts a
    one-hot (to keep a sharded vocab dim local): the contraction has one
    nonzero term, so the number is the same, and at qwen3-0.6b's training
    shape the one-hot would be 8,192 × 152,064 fp32 values (5 GB)."""
    logits, aux = logits_fn(p, batch, cfg, impl=impl)
    labels = batch["labels"]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None].long())[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    nll = torch.where(labels >= 0, nll, 0.0)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll) / denom
    total = loss + aux_weight * aux
    return total, {"nll": loss, "aux": aux,
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prefill(p, batch: dict, cfg: ArchConfig, *, max_len: int,
            impl: str = "flash_pallas"):
    """Process the prompt; returns (last-token logits (B, 1, V), cache)."""
    cdt = _compute_dtype(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.apply_embed(p["embed"], tokens, cdt)
    x, cache = T.apply_stack_prefill(p["stack"], x, cfg,
                                     pos=_positions(B, S, tokens.device),
                                     max_len=max_len, pos3=batch.get("pos3"),
                                     impl=impl, compute_dtype=cdt)
    x = L.apply_norm(p["final_norm"], x[:, -1:], cfg.norm_kind)
    return _head(p, x, cfg, cdt), cache


def decode(p, cache, tokens: Tensor, pos, cfg: ArchConfig, *,
           pos3: Optional[Tensor] = None):
    """One decode step. tokens (B, 1); pos the current absolute position
    (an int). Returns (logits (B, 1, V), cache), the cache updated in
    place."""
    cdt = _compute_dtype(cfg)
    x = L.apply_embed(p["embed"], tokens, cdt)
    x, cache = T.apply_stack_decode(p["stack"], cache, x, cfg, pos=pos,
                                    pos3=pos3, compute_dtype=cdt)
    x = L.apply_norm(p["final_norm"], x, cfg.norm_kind)
    return _head(p, x, cfg, cdt), cache


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int) -> list:
    check_supported(cfg)
    return T.stack_cache_shape(cfg, batch, max_len)
