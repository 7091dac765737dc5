"""Mamba-1 block (falcon-mamba-7b): selective SSM, attention-free.

Port of ``repro.models.mamba``: the chunked forward (training and
prefill), its hand-written backward, and the one-token decode step.
Structure per layer (Gu & Dao 2023):

  x -> in_proj -> (x_branch, z_gate)           d -> 2 * d_inner
  x_branch -> causal depthwise conv1d (width 4) -> silu
  -> selective scan: h_t = Ā_t h_{t-1} + B̄_t x_t ; y_t = C_t h_t + D x_t
     with Ā_t = exp(Δ_t A), B̄_t = Δ_t B_t (ZOH), A diagonal (d_inner, N)
  y * silu(z_gate) -> out_proj                 d_inner -> d

The scan runs the reference's chunks: 64-step chunks, within a chunk the
diagonal recurrence as a log-depth scan of affine maps
(``layers.affine_scan``), across chunks a carried (B, d_inner, N) fp32
state, so peak memory stays O(B · 64 · d_inner · N) whatever T is. The
scan is plain PyTorch, as the reference's is plain JAX (no TPU kernel).

Training goes through the reference's hand-written VJP
(``_chunked_ssm_bwd``), here :class:`_ChunkedSSM`: the forward saves its
inputs and each chunk's incoming state (33.5 MB a layer at B = 2 × 2,048
for falcon-mamba-7b), and the backward re-expands one chunk at a time and
runs the adjoint recurrence as a reverse scan. Autograd through the
chunk loop would keep every round of every chunk's (64, B, d_inner, N)
scan instead (tens of GB a layer at that batch).

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


def _tm(t: Tensor) -> Tensor:
    """(B, Lc, ...) -> time-major (Lc, B, ...) fp32, contiguous."""
    return t.float().transpose(0, 1).contiguous()


def _chunk_fwd(A: Tensor, h: Tensor, d_c: Tensor, B_c: Tensor, C_c: Tensor,
               x_c: Tensor):
    """One chunk forward, time-major inside (the scan's slices are then
    contiguous): (y (B, Lc, di), h_all (Lc, B, di, N), h_last, a (Lc, B,
    di, N))."""
    d_f, x_f, B_f, C_f = _tm(d_c), _tm(x_c), _tm(B_c), _tm(C_c)
    a = torch.exp(d_f[..., None] * A)                     # (Lc,B,di,N)
    bx = (d_f * x_f)[..., None] * B_f[:, :, None, :]
    hs, h_last = _chunk_scan(a, bx, h)
    y = torch.einsum("lbds,lbs->bld", hs, C_f)
    return y, hs, h_last, a


def _ssm_forward(delta: Tensor, Bm: Tensor, Cm: Tensor, xb: Tensor,
                 A: Tensor, h0: Tensor, bounds: list | None = None):
    """The chunk loop of the forward: (y (B, T, di) fp32, h_last (B, di,
    N) fp32); each chunk's incoming state appended to ``bounds`` if one
    is given."""
    T = xb.shape[1]
    Lc = min(_CHUNK, T)
    h = h0.float()
    ys = []
    for c0 in range(0, T, Lc):
        sl = slice(c0, c0 + Lc)
        if bounds is not None:
            bounds.append(h)
        y, _, h, _ = _chunk_fwd(A, h, delta[:, sl], Bm[:, sl], Cm[:, sl],
                                xb[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1), h


class _ChunkedSSM(torch.autograd.Function):
    """The reference's ``_chunked_ssm`` with its hand-written VJP
    (``mamba.py:117-222``): the forward keeps only the inputs and each
    chunk's incoming state ``h_bounds`` (n_chunks, B, d_inner, N) fp32;
    the backward walks the chunks in reverse, re-expands each with
    :func:`_chunk_fwd`, and runs the adjoint recurrence r_t = h̄_t +
    a_{t+1} r_{t+1} inside it as the same log-depth scan on flipped
    arrays (``layers.affine_scan_adjoint``), where h̄_t = dy_t C_t plus,
    at the chunk's last step, the cotangent carried from the next chunk
    (the last chunk's: the cotangent into h_last). Autograd through the
    forward would keep every round of every chunk's (Lc, B, d_inner, N)
    scan instead (``tests/test_torch_mamba.py`` counts the bytes)."""

    @staticmethod
    def forward(ctx, delta, Bm, Cm, xb, A, h0):
        bounds = []
        y, h = _ssm_forward(delta, Bm, Cm, xb, A, h0, bounds)
        ctx.save_for_backward(delta, Bm, Cm, xb, A, torch.stack(bounds))
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_last):
        delta, Bm, Cm, xb, A, h_bounds = ctx.saved_tensors
        T = xb.shape[1]
        Lc = min(_CHUNK, T)
        rc = dh_last.float()             # the cotangent into h_last
        dA = torch.zeros(A.shape, dtype=torch.float32, device=A.device)
        Af = A.float()
        outs = []
        for c in reversed(range(T // Lc)):
            sl = slice(c * Lc, (c + 1) * Lc)
            h_in = h_bounds[c]
            _, hs, _, a = _chunk_fwd(A, h_in, delta[:, sl], Bm[:, sl],
                                     Cm[:, sl], xb[:, sl])
            d_f, x_f, B_f, C_f, dy_f = (_tm(t[:, sl]) for t in
                                        (delta, xb, Bm, Cm, dy))
            # the cotangent of each h_t from y_t = C_t . h_t, plus the
            # carry into the chunk's last state
            hbar = dy_f[..., None] * C_f[:, :, None, :]    # (Lc,B,di,N)
            hbar[-1] += rc
            r = L.affine_scan_adjoint(a, hbar)
            h_prev = torch.cat([h_in[None], hs[:-1]])
            dada = r * h_prev * a             # da · a: da/d(delta A) = a
            # a = exp(delta A): ddelta = sum_n da a A, dA += sum da a delta
            ddelta = (dada * Af).sum(-1)                   # (Lc,B,di)
            dA += torch.einsum("lbds,lbd->ds", dada, d_f)
            # bx = (delta x)[..., None] B[:, :, None, :], dbx = r
            dB = torch.einsum("lbds,lbd->lbs", r, d_f * x_f)
            ddx = (r * B_f[:, :, None, :]).sum(-1)        # (Lc,B,di)
            ddelta += ddx * x_f
            dC = torch.einsum("lbd,lbds->lbs", dy_f, hs)
            outs.append((ddelta, dB, dC, ddx * d_f))
            rc = a[0] * r[0]                  # into the previous chunk
        dd, dB, dC, dx = (torch.cat([o[i] for o in reversed(outs)])
                          .transpose(0, 1) for i in range(4))
        return (dd.to(delta.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype),
                dx.to(xb.dtype), dA.to(A.dtype), rc)


def _chunked_ssm(delta: Tensor, Bm: Tensor, Cm: Tensor, xb: Tensor,
                 A: Tensor, h0: Tensor):
    """y_t = C_t · h_t with h_t = exp(δ_t A) h_{t-1} + δ_t x_t B_t, chunk
    by chunk (the reference's ``_chunked_ssm``; T a multiple of the
    chunk, or shorter than one). Returns (y (B, T, di) fp32, h_last (B,
    di, N) fp32). Differentiable through :class:`_ChunkedSSM`'s
    hand-written backward; without autograd the same forward runs
    alone."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (delta, Bm, Cm, xb, A, h0)):
        return _ChunkedSSM.apply(delta, Bm, Cm, xb, A, h0)
    return _ssm_forward(delta, Bm, Cm, xb, A, h0)


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
