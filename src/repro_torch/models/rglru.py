"""RG-LRU recurrent block (recurrentgemma-9b / Griffin, arXiv:2402.19427).

Port of ``repro.models.rglru`` (training, prefill, decode). The
recurrent block (the
"rec" element of the (rec, rec, attn) pattern):

  x -> [branch 1] linear (d -> w) -> causal conv1d (width 4) -> RG-LRU
       [branch 2] linear (d -> w) -> GeLU
  out = (branch1 * branch2) -> linear (w -> d)

RG-LRU cell (diagonal gated linear recurrence):

  r_t = sigmoid(W_a x_t + b_a)          recurrence gate
  i_t = sigmoid(W_x x_t + b_x)          input gate
  a_t = exp(c * softplus(Λ) * (-r_t))   per-channel decay, Λ learned, c=8
  h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

Training and prefill scan the whole sequence at once with the log-depth
scan of affine maps (``layers.affine_scan``; the state is (B, w) a step,
so no chunking), in plain PyTorch, as the reference's
``associative_scan`` is plain JAX (no TPU kernel). The scan's backward
is ``affine_scan``'s own, the reverse scan (saving the decays and the
states); the gates' is autograd's. Decode is the exact one-step
recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Tensor = torch.Tensor

_C = 8.0      # Griffin's fixed decay temperature


def width(cfg: ArchConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def init(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    """The reference's parameters and distributions; Λ such that a lies
    uniformly in (0.9, 0.999) at r = 1 (Griffin A.2)."""
    w = width(cfg)
    dev = gen.device

    def zeros():
        return torch.zeros(w, dtype=dtype, device=dev)

    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, w, device=dev)) / _C))
    return {
        "in_x": {"w": L._normal(gen, (cfg.d_model, w), dtype,
                                cfg.d_model ** -0.5)},
        "in_gate": {"w": L._normal(gen, (cfg.d_model, w), dtype,
                                   cfg.d_model ** -0.5)},
        "conv": {"w": L._normal(gen, (cfg.rglru.conv, w), dtype, 0.1),
                 "b": zeros()},
        "gate_a": {"w": L._normal(gen, (w, w), dtype, w ** -0.5),
                   "b": zeros()},
        "gate_x": {"w": L._normal(gen, (w, w), dtype, w ** -0.5),
                   "b": zeros()},
        "lam": lam.to(dtype),
        "out": {"w": L._normal(gen, (w, cfg.d_model), dtype, w ** -0.5)},
    }


def _lru_coeffs(p, xc: Tensor):
    """Per-step (a_t, b_t) of the diagonal recurrence, fp32, from the conv
    output xc (..., w)."""
    r = torch.sigmoid(xc @ p["gate_a"]["w"].to(xc.dtype)
                      + p["gate_a"]["b"].to(xc.dtype))
    i = torch.sigmoid(xc @ p["gate_x"]["w"].to(xc.dtype)
                      + p["gate_x"]["b"].to(xc.dtype))
    lam = F.softplus(p["lam"].float())
    log_a = -_C * lam * r.float()
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1
    gate = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))
    b = gate * (i.float() * xc.float())
    return a, b


_causal_conv = L.causal_conv


def in_branches(p, x: Tensor, compute_dtype):
    """x (B, T, D) -> (xb before the conv, xc = conv(xb), g = gelu gate)."""
    xb = L.apply_dense(p["in_x"], x, compute_dtype)       # (B, T, w)
    g = F.gelu(L.apply_dense(p["in_gate"], x, compute_dtype),
               approximate="tanh")
    return xb, _causal_conv(xb, p["conv"], compute_dtype), g


def scan(p, xc: Tensor) -> Tensor:
    """h (B, T, w) fp32 of the RG-LRU over the conv output, from h = 0:
    the coefficients and the scan time-major (T, B, w), where the scan's
    slices are contiguous; h comes back as a (B, T, w) view."""
    a, b = _lru_coeffs(p, xc.transpose(0, 1).contiguous())
    return L.affine_scan(a, b).transpose(0, 1)


def forward(p, x: Tensor, cfg: ArchConfig, compute_dtype) -> Tensor:
    """Full-sequence recurrent block (prefill)."""
    _, xc, g = in_branches(p, x, compute_dtype)
    y = scan(p, xc).to(compute_dtype) * g
    return L.apply_dense(p["out"], y, compute_dtype)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def state_shape(cfg: ArchConfig, batch: int, dtype=torch.bfloat16) -> dict:
    """The decode state as meta tensors: h (B, w) fp32, conv (B, K-1, w)
    of ``dtype``."""
    w = width(cfg)
    return {"h": torch.empty(batch, w, device="meta"),
            "conv": torch.empty(batch, cfg.rglru.conv - 1, w, dtype=dtype,
                                device="meta")}


def init_state(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> dict:
    return {n: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for n, t in state_shape(cfg, batch, dtype).items()}


def decode_step(p, state, x: Tensor, cfg: ArchConfig, compute_dtype):
    """One-token step. x (B, 1, D) -> (out (B, 1, D), new state)."""
    xb = L.apply_dense(p["in_x"], x[:, 0], compute_dtype)  # (B, w)
    g = F.gelu(L.apply_dense(p["in_gate"], x[:, 0], compute_dtype),
               approximate="tanh")
    hist = torch.cat([state["conv"].to(compute_dtype), xb[:, None]], dim=1)
    wconv = p["conv"]["w"].to(compute_dtype)
    xc = torch.einsum("bkd,kd->bd", hist, wconv) + \
        p["conv"]["b"].to(compute_dtype)
    a, b = _lru_coeffs(p, xc)
    h = a * state["h"] + b
    y = h.to(compute_dtype) * g
    out = L.apply_dense(p["out"], y, compute_dtype)[:, None]
    return out, {"h": h, "conv": hist[:, 1:].to(state["conv"].dtype)}
