"""Mamba-1 block (falcon-mamba-7b): selective SSM, attention-free.

Port of ``repro.models.mamba`` for serving: the chunked forward (prefill)
and the one-token decode step. Structure per layer (Gu & Dao 2023):

  x -> in_proj -> (x_branch, z_gate)           d -> 2 * d_inner
  x_branch -> causal depthwise conv1d (width 4) -> silu
  -> selective scan: h_t = Ā_t h_{t-1} + B̄_t x_t ; y_t = C_t h_t + D x_t
     with Ā_t = exp(Δ_t A), B̄_t = Δ_t B_t (ZOH), A diagonal (d_inner, N)
  y * silu(z_gate) -> out_proj                 d_inner -> d

Prefill runs the reference's chunked scan: 64-step chunks, within a chunk
the diagonal recurrence as a log-depth scan of affine maps
(``layers.affine_scan``), across chunks a carried (B, d_inner, N) fp32
state, so peak memory stays O(B · 64 · d_inner · N) whatever T is. The
scan is plain PyTorch, as the reference's is plain JAX (no TPU kernel).

The reference's hand-written VJP (``_chunked_ssm_bwd``) belongs to
training, which waits (ROADMAP A18, training of the ssm and hybrid
families; ``train.steps.make_train_step`` raises for this family):
without it autograd would keep every chunk's (B, 64, d_inner, N)
intermediates.

Decode is the exact single-step recurrence on the carried state. Like
the reference, the state is a new ``{"h", "conv"}`` dict each step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Tensor = torch.Tensor

_CHUNK = 64


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def dt_rank(cfg: ArchConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def init(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    """The reference's parameters and distributions: A_log = log(1..N)
    per channel (S4D-real), dt_proj's bias log(expm1(0.01)), D ones."""
    di, N, R = d_inner(cfg), cfg.ssm.state, dt_rank(cfg)
    dev = gen.device
    return {
        "in_proj": {"w": L._normal(gen, (cfg.d_model, 2 * di), dtype,
                                   cfg.d_model ** -0.5)},
        "conv": {"w": L._normal(gen, (cfg.ssm.conv, di), dtype, 0.1),
                 "b": torch.zeros(di, dtype=dtype, device=dev)},
        # x -> (Delta_rank, B, C) data-dependent SSM params
        "x_proj": {"w": L._normal(gen, (di, R + 2 * N), dtype, di ** -0.5)},
        "dt_proj": {"w": L._normal(gen, (R, di), dtype, R ** -0.5),
                    "b": torch.full((di,), math.log(math.expm1(0.01)),
                                    dtype=dtype, device=dev)},
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                        device=dev)).expand(di, N)
        .to(dtype).contiguous(),
        "D": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": {"w": L._normal(gen, (di, cfg.d_model), dtype,
                                    di ** -0.5)},
    }


def _ssm_params(p, xb: Tensor, cfg: ArchConfig):
    """Data-dependent (Delta, B, C) from the conv branch xb (..., di)."""
    N, R = cfg.ssm.state, dt_rank(cfg)
    dbc = xb @ p["x_proj"]["w"].to(xb.dtype)              # (..., R+2N)
    dt, Bm, Cm = torch.split(dbc, [R, N, N], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"]["w"].to(xb.dtype)
                       + p["dt_proj"]["b"].to(xb.dtype))  # (..., di)
    return delta, Bm, Cm


def _chunk_scan(a: Tensor, bx: Tensor, h0: Tensor):
    """Diagonal linear recurrence within one chunk, time-major (the
    reference's a, bx are (B, Lc, di, N); here (Lc, B, di, N), so the
    scan's slices are contiguous), h0 (B, di, N); h_t = a_t h_{t-1} +
    bx_t for every t (log depth). h0 is folded into the first step (a_0
    h0 + bx_0), so the scan's b prefixes are the states and the prefix
    products of a are never applied. Returns (h (Lc, B, di, N), h_last
    (B, di, N), a copy)."""
    bx = torch.cat([a[:1] * h0 + bx[:1], bx[1:]])
    h = L.affine_scan(a, bx)
    return h, h[-1].clone()


def _chunk_fwd(A: Tensor, h: Tensor, d_c: Tensor, B_c: Tensor, C_c: Tensor,
               x_c: Tensor):
    """One chunk forward, time-major inside (the scan's slices are then
    contiguous): (y (B, Lc, di), h_all (Lc, B, di, N), h_last, a (Lc, B,
    di, N))."""
    def tm(t):                                            # (Lc, B, ...)
        return t.float().transpose(0, 1).contiguous()
    d_f, x_f, B_f, C_f = tm(d_c), tm(x_c), tm(B_c), tm(C_c)
    a = torch.exp(d_f[..., None] * A)                     # (Lc,B,di,N)
    bx = (d_f * x_f)[..., None] * B_f[:, :, None, :]
    hs, h_last = _chunk_scan(a, bx, h)
    y = torch.einsum("lbds,lbs->bld", hs, C_f)
    return y, hs, h_last, a


def _chunked_ssm(delta: Tensor, Bm: Tensor, Cm: Tensor, xb: Tensor,
                 A: Tensor, h0: Tensor):
    """y_t = C_t · h_t with h_t = exp(δ_t A) h_{t-1} + δ_t x_t B_t, chunk
    by chunk (the forward of the reference's ``_chunked_ssm``; T a
    multiple of the chunk, or shorter than one). Returns (y (B, T, di)
    fp32, h_last (B, di, N) fp32)."""
    T = xb.shape[1]
    Lc = min(_CHUNK, T)
    h = h0.float()
    ys = []
    for c0 in range(0, T, Lc):
        sl = slice(c0, c0 + Lc)
        y, _, h, _ = _chunk_fwd(A, h, delta[:, sl], Bm[:, sl], Cm[:, sl],
                                xb[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def scan_sequence(p, xb: Tensor, cfg: ArchConfig, h0: Tensor,
                  chunk: int = 64):
    """Full selective scan. xb (B, T, di) conv+silu output; h0 (B, di, N).

    Returns (y (B, T, di), h_final)."""
    del chunk                                             # fixed _CHUNK
    T = xb.shape[1]
    delta, Bm, Cm = _ssm_params(p, xb, cfg)               # (B,T,di),(B,T,N)
    A = -torch.exp(p["A_log"].float())                    # (di, N)
    # pad T to a chunk multiple: delta=0 => a=1, bx=0, so padded steps pass
    # the state through unchanged and their y is discarded.
    Lc = min(_CHUNK, T)
    Tp = -(-T // Lc) * Lc
    xb_p = xb
    if Tp != T:
        pad = (0, 0, 0, Tp - T)
        delta, xb_p, Bm, Cm = (F.pad(t, pad) for t in (delta, xb, Bm, Cm))
    y, h_final = _chunked_ssm(delta, Bm, Cm, xb_p, A, h0.float())
    y = y[:, :T] + xb.float() * p["D"].float()
    return y.to(xb.dtype), h_final


_causal_conv = L.causal_conv      # y_t = sum_k w_k x_{t-K+1+k} + b


def in_branches(p, x: Tensor, compute_dtype):
    """x (B, T, D) -> (xb before the conv, xc = silu(conv(xb)), z)."""
    xb, z = torch.chunk(L.apply_dense(p["in_proj"], x, compute_dtype), 2,
                        dim=-1)
    return xb, F.silu(_causal_conv(xb, p["conv"], compute_dtype)), z


def forward(p, x: Tensor, cfg: ArchConfig, compute_dtype,
            chunk: int = 64) -> Tensor:
    """Full-sequence mamba block (prefill, no state in/out)."""
    B = x.shape[0]
    _, xc, z = in_branches(p, x, compute_dtype)
    h0 = torch.zeros(B, d_inner(cfg), cfg.ssm.state, device=x.device)
    y, _ = scan_sequence(p, xc, cfg, h0, chunk=chunk)
    return L.apply_dense(p["out_proj"], y * F.silu(z), compute_dtype)


# ---------------------------------------------------------------------------
# decode (single step, carried state)
# ---------------------------------------------------------------------------

def state_shape(cfg: ArchConfig, batch: int, dtype=torch.bfloat16) -> dict:
    """The decode state as meta tensors: h (B, di, N) fp32, conv (B, K-1,
    di) of ``dtype``."""
    di = d_inner(cfg)
    return {"h": torch.empty(batch, di, cfg.ssm.state, device="meta"),
            "conv": torch.empty(batch, cfg.ssm.conv - 1, di, dtype=dtype,
                                device="meta")}


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device=None) -> dict:
    return {n: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for n, t in state_shape(cfg, batch, dtype).items()}


def decode_step(p, state, x: Tensor, cfg: ArchConfig, compute_dtype):
    """One-token step. x (B, 1, D) -> (out (B, 1, D), new state)."""
    xb, z = torch.chunk(L.apply_dense(p["in_proj"], x[:, 0], compute_dtype),
                        2, dim=-1)                        # (B, di)
    # conv ring: state["conv"] holds the previous K-1 inputs
    hist = torch.cat([state["conv"].to(compute_dtype), xb[:, None]], dim=1)
    w = p["conv"]["w"].to(compute_dtype)
    xc = F.silu(torch.einsum("bkd,kd->bd", hist, w)
                + p["conv"]["b"].to(compute_dtype))
    delta, Bm, Cm = _ssm_params(p, xc, cfg)               # (B,di),(B,N)
    A = -torch.exp(p["A_log"].float())
    d_f = delta.float()
    a = torch.exp(d_f[..., None] * A)                     # (B, di, N)
    bx = (d_f * xc.float())[..., None] * Bm.float()[:, None, :]
    h = a * state["h"] + bx
    y = torch.einsum("bds,bs->bd", h, Cm.float())
    y = y + xc.float() * p["D"].float()
    y = y.to(compute_dtype) * F.silu(z)
    out = L.apply_dense(p["out_proj"], y, compute_dtype)[:, None]
    return out, {"h": h, "conv": hist[:, 1:].to(state["conv"].dtype)}
