"""Primitive layers: norms, projections, embeddings, RoPE, MLPs, and the
recurrent blocks' causal conv and log-depth scan.

Port of ``repro.models.layers``. Parameters are ``nn.ParameterDict``s
keyed as the reference's dict pytrees are (``{"w", "b"}``,
``{"scale", "bias"}``, ``{"table"}``, ...), so ``p["w"]`` and
``"b" in p`` read the same on both sides. Weights keep the reference's
``(in, out)`` layout (``x @ w``) and its casts: ``apply_dense`` casts
``w`` to the compute dtype on every call, norms work in fp32 and cast
back to the activation dtype, RoPE works in fp32. The init functions
draw from a ``torch.Generator`` with the reference's distributions (the
numbers differ from ``jax.random``'s; parity tests carry the weights
across with ``repro_torch.interop.lm_params_from_numpy``).

The reference's ``precision_boundary`` has no counterpart: it is the
identity, there only to steer XLA's placement of converts around
collectives, and its backward's contract (a sublayer output's cotangent
is rounded to the activation dtype) is autograd's own: the gradient of a
bf16 tensor is bf16. Likewise ``apply_dense``'s per-call cast of an fp32
``w`` to the compute dtype carries the gradient back cast to fp32, as
``x @ w.astype(cdt)`` does in JAX (``tests/test_torch_train.py`` checks
both). With bf16 compute the whole model's gradients lie within 0.05 of
each leaf's largest from the reference's (its worst leaf over five
seeds: qwen3-0.6b 0.023, smollm-135m 0.037, granite-8b 0.025,
qwen2.5-14b 0.039 of the smoke configs, on the CPU): the frameworks
round bf16 matmuls and their gradients at other places. ``apply_mrope``
raises (Qwen2-VL's M-RoPE waits for ROADMAP A18). The recurrent blocks'
log-depth scan :func:`affine_scan` is differentiable (its backward the
reverse scan, :func:`affine_scan_adjoint`); mamba's chunked scan has its
own backward (``mamba._ChunkedSSM``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# initializers: nested dicts of tensors, the reference's pytrees
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, dtype, scale: float) -> Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype) * scale


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               bias: bool = False) -> dict:
    p = {"w": _normal(gen, (in_dim, out_dim), dtype, in_dim ** -0.5)}
    if bias:
        p["b"] = torch.zeros(out_dim, dtype=dtype, device=gen.device)
    return p


def apply_dense(p, x: Tensor, compute_dtype) -> Tensor:
    y = x @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(dim: int, kind: str, dtype, device=None) -> dict:
    p = {"scale": torch.ones(dim, dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(dim, dtype=dtype, device=device)
    return p


def apply_norm(p, x: Tensor, kind: str, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def qk_norm_init(dh: int, dtype, device=None) -> dict:
    return {"q_scale": torch.ones(dh, dtype=dtype, device=device),
            "k_scale": torch.ones(dh, dtype=dtype, device=device)}


def apply_head_rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm over the trailing head_dim (qwen3 qk_norm)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> dict:
    # d^-0.5 keeps tied-unembed logits O(1) at init (loss starts ~ log V)
    return {"table": _normal(gen, (vocab, dim), dtype, dim ** -0.5)}


def apply_embed(p, ids: Tensor, compute_dtype) -> Tensor:
    # F.embedding, not indexing: its backward on the card sums the rows of
    # repeated ids in a fixed order, where indexing's (index_put_ with
    # accumulate) adds them with atomics in an order that varies by run
    return F.embedding(ids, p["table"]).to(compute_dtype)


def apply_unembed(p, x: Tensor, compute_dtype) -> Tensor:
    """Tied output head: logits = x @ tableᵀ."""
    return x @ p["table"].to(compute_dtype).T


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dh: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """x (..., S, H, dh); pos (..., S) integer positions."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)              # (dh/2,)
    angles = pos[..., None].float() * freqs              # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: Tensor, pos3: Tensor, theta: float, sections: tuple):
    raise NotImplementedError(
        "M-RoPE (the vlm family, qwen2-vl) is not ported yet: ROADMAP A18")


# ---------------------------------------------------------------------------
# the recurrent blocks' shared pieces (mamba, rglru)
# ---------------------------------------------------------------------------

def causal_conv(xb: Tensor, pc, compute_dtype) -> Tensor:
    """Depthwise causal conv1d of width K over (B, T, d): y_t = sum_k w_k
    x_{t-K+1+k} + b (the reference's ``mamba._causal_conv`` and
    ``rglru._causal_conv``, one function here)."""
    K, T = pc["w"].shape[0], xb.shape[1]
    w = pc["w"].to(compute_dtype)                        # (K, d)
    pads = F.pad(xb, (0, 0, K - 1, 0))
    y = sum(pads[:, k:k + T, :] * w[k] for k in range(K))
    return y + pc["b"].to(compute_dtype)


def _scan(a: Tensor, b: Tensor) -> Tensor:
    """The states h_t = a_t h_{t-1} + b_t from h = 0 along the leading
    (time) axis, log depth (Hillis–Steele): ⌈log₂ T⌉ rounds, each three
    whole-tensor elementwise kernels written into fresh buffers, so a
    4,096-step sequence is 12 rounds and never a Python loop over steps.
    Time-major, so every slice is contiguous and PyTorch's vectorized
    kernels run. No division by prefix products, so a product of decays
    that underflows to 0 stays exact."""
    n = a.shape[0]
    a, b = a.contiguous(), b.contiguous()
    step = 1
    while step < n:
        nb = torch.empty_like(b)
        nb[:step] = b[:step]
        torch.mul(a[step:], b[:-step], out=nb[step:])
        nb[step:] += b[step:]
        if 2 * step < n:                  # a's prefixes feed later rounds
            na = torch.empty_like(a)
            na[:step] = a[:step]
            torch.mul(a[:-step], a[step:], out=na[step:])
            a = na
        b = nb
        step *= 2
    return b


def affine_scan_adjoint(a: Tensor, g: Tensor) -> Tensor:
    """The adjoint of h_t = a_t h_{t-1} + b_t: r_t = g_t + a_{t+1}
    r_{t+1} (r_{T-1} = g_{T-1}), the cotangent of every h_t given the
    cotangents g_t of the states, so that db_t = r_t and da_t = r_t
    h_{t-1}. The same forward scan on flipped arrays, a shifted by one
    (its first decay multiplies the zero state, so it is never read)."""
    af = torch.cat([torch.ones_like(a[:1]), a[1:].flip(0)])
    return _scan(af, g.flip(0)).flip(0)


class _AffineScan(torch.autograd.Function):
    """:func:`affine_scan` with its backward: the reverse scan of
    :func:`affine_scan_adjoint`, from the saved decays and states (a and
    h, nothing else). No division by prefix products either way, so
    decays that underflow stay exact in the backward too."""

    @staticmethod
    def forward(ctx, a, b):
        h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        r = affine_scan_adjoint(a, g)
        da = None
        if ctx.needs_input_grad[0]:
            da = torch.empty_like(r)
            da[0] = 0.0                   # h_{-1} = 0
            torch.mul(r[1:], h[:-1], out=da[1:])
        return da, r


def affine_scan(a: Tensor, b: Tensor) -> Tensor:
    """The states h_t = a_t h_{t-1} + b_t from h = 0, along the leading
    (time) axis: the b half of every prefix of the affine maps h -> a h +
    b under the composition (a2, b2) ∘ (a1, b1) = (a2 a1, a2 b1 + b2)
    that the reference hands to ``jax.lax.associative_scan``
    (``mamba.py:101``, ``rglru.py:98``).

    Log-depth (:func:`_scan`); the rounding differs from the reference's
    tree by fp32 ordering only. Differentiable: the backward is the
    reverse scan of :func:`affine_scan_adjoint` (``jax.grad`` of the
    reference's ``associative_scan``, ``tests/test_torch_mamba.py``),
    saving a and h only."""
    return _AffineScan.apply(a, b)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype) -> dict:
    if act == "silu":                                    # SwiGLU: 3 matrices
        return {"wi": dense_init(gen, d_model, d_ff, dtype),
                "wg": dense_init(gen, d_model, d_ff, dtype),
                "wo": dense_init(gen, d_ff, d_model, dtype)}
    return {"wi": dense_init(gen, d_model, d_ff, dtype),  # plain 2-mat GELU
            "wo": dense_init(gen, d_ff, d_model, dtype)}


def apply_mlp(p, x: Tensor, act: str, compute_dtype) -> Tensor:
    if act == "silu":
        h = F.silu(apply_dense(p["wg"], x, compute_dtype)) * \
            apply_dense(p["wi"], x, compute_dtype)
    else:
        h = F.gelu(apply_dense(p["wi"], x, compute_dtype), approximate="tanh")
    return apply_dense(p["wo"], h, compute_dtype)
