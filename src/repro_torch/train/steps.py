"""Train / serve step builders: the functions the launchers call.

Port of ``repro.train.steps``. PyTorch runs eagerly, so a builder returns
the plain function (the reference's launchers jit it).

``make_train_step``: the value and gradients of ``model.loss_fn``
(``torch.autograd.grad`` over the parameters) + the AdamW update, with
optional gradient accumulation (microbatches summed into fp32 zeros in
order, then divided), gradient compression (the error-feedback codec
before the update, standing in for a compressed DP all-reduce), and
remat governed by the ArchConfig (``transformer._remat``). It trains the
families the port builds: dense, ssm (falcon-mamba: the chunked
selective scan's hand-written backward, ``mamba._ChunkedSSM``) and hybrid
(recurrentgemma: the RG-LRU through ``layers.affine_scan``'s reverse
scan, the local attention through F and N1 at head dim 256). The moe,
encdec and vlm families raise (``model.check_supported``, ROADMAP A18).

``make_serve_step`` / ``make_prefill``: the decode / prefill entry points
of the serving launcher.

A train state is the reference's dict: ``{"params": the parameter module,
"opt": AdamWState, ["ef": EFState]}``; the step updates it in place and
returns it. The sharded step (the reference's in/out axes under a mesh)
is the LM's mesh path, ROADMAP A17 (third part).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw, compress as comp
from repro_torch.optim.adamw import leaves, tree_map, unflatten

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    compression: comp.CompressConfig = dataclasses.field(
        default_factory=comp.CompressConfig)
    grad_accum: int = 1            # microbatches per step
    attn_impl: str = "flash_xla"   # flash_xla | ref (flash_pallas: no grad)
    aux_weight: float = 0.01


class TrainState:
    """The state dict: params + optimizer (+ EF residual)."""

    @staticmethod
    def create(params, use_ef: bool) -> dict:
        st = {"params": params, "opt": adamw.init(params)}
        if use_ef:
            st["ef"] = comp.init(params)
        return st

    @staticmethod
    def shapes(param_shapes_, use_ef: bool) -> dict:
        """The state as meta tensors."""
        st = {"params": param_shapes_,
              "opt": adamw.state_shapes(param_shapes_)}
        if use_ef:
            st["ef"] = comp.EFState(residual=tree_map(
                lambda p: torch.empty(p.shape, dtype=torch.float32,
                                      device="meta"), param_shapes_))
        return st

    @staticmethod
    def axes(param_axes, use_ef: bool) -> dict:
        st = {"params": param_axes, "opt": adamw.state_axes(param_axes)}
        if use_ef:
            st["ef"] = comp.EFState(residual=param_axes)
        return st


def make_train_step(cfg: ArchConfig, tc: TrainConfig):
    """(state, batch) -> (state, metrics {nll, aux, ppl_proxy, grad_norm,
    lr, loss}). Raises for a family the port does not build
    (``model.check_supported``)."""
    M.check_supported(cfg)
    use_ef = tc.compression.codec != "none"

    def grads_of(params, batch):
        ps = leaves(params)
        loss, mets = M.loss_fn(params, batch, cfg, impl=tc.attn_impl,
                               aux_weight=tc.aux_weight)
        gs = torch.autograd.grad(loss, ps)
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, gs

    def step(state, batch):
        params = state["params"]
        if tc.grad_accum > 1:
            g_sum = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            l_sum = torch.zeros((), dtype=torch.float32,
                                device=g_sum[0].device)
            for mb in _split_microbatches(batch, tc.grad_accum):
                lval, metrics, gs = grads_of(params, mb)
                for acc, g in zip(g_sum, gs):
                    acc.add_(g)
                l_sum = l_sum + lval
            gs = [g / tc.grad_accum for g in g_sum]
            lval = l_sum / tc.grad_accum
        else:
            lval, metrics, gs = grads_of(params, batch)
        grads = unflatten(params, gs)
        if use_ef:
            grads, state["ef"] = comp.compress(tc.compression, state["ef"],
                                               grads)
        _, state["opt"], omets = adamw.update(tc.optimizer, state["opt"],
                                              params, grads)
        return state, {**metrics, **omets, "loss": lval}

    return step


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n microbatches of B/n, in order (the reference's scan
    input, ``steps.py:117``)."""
    def sp(x, i):
        if x.ndim >= 2 and x.shape[0] % n == 0:
            per = x.shape[0] // n
            return x[i * per:(i + 1) * per]
        if x.ndim == 3 and x.shape[1] % n == 0:     # pos3 (3, B, S)
            per = x.shape[1] // n
            return x[:, i * per:(i + 1) * per]
        return x
    return [{k: sp(v, i) for k, v in batch.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

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
