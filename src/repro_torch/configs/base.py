"""ArchConfig — the selectable architecture description.

One file per assigned architecture lives next to this module; each exports
``CONFIG`` (the exact published shape) and ``SMOKE`` (a reduced same-family
config for CPU tests). ``registry.get(name)`` resolves either.

The four assigned input shapes are global (see ``SHAPES``): ``train_4k``
lowers train_step; ``prefill_32k`` lowers prefill; ``decode_32k`` /
``long_500k`` lower serve_step (one new token against a seq_len KV cache).

Copy of ``repro.configs.base`` for the port. The port builds models of
the dense, ssm and hybrid families
(``repro_torch.models.model.check_supported``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 16
    top_k: int = 4
    d_ff_expert: int = 0          # per-expert hidden (defaults to d_ff)
    shared_expert: bool = False   # llama4-style always-on shared expert
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 16               # N: per-channel state size (mamba1)
    conv: int = 4                 # depthwise conv kernel width
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: int = 0              # defaults to ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    # recurrentgemma/Griffin: pattern unit = (rec, rec, attn)
    block_pattern: tuple = ("rec", "rec", "attn")
    window: int = 2048            # local attention window
    conv: int = 4
    lru_width: int = 0            # defaults to d_model


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int = 12
    frontend_dim: int = 80        # stub modality frontend embedding dim
    frontend_len: int = 1024      # precomputed frame/patch positions


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str = "model"
    family: str = "dense"         # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 4096
    vocab: int = 32000
    head_dim: int = 0             # defaults to d_model // n_heads
    # attention options
    qk_norm: bool = False         # qwen3
    qkv_bias: bool = False        # qwen2.5 / qwen2-vl
    rope_theta: float = 10000.0
    rope_kind: str = "rope"       # rope | mrope | none
    mrope_sections: tuple = (16, 24, 24)   # qwen2-vl M-RoPE split of head_dim/2
    # llama4 iRoPE: every `global_every`-th layer is global attention w/o rope
    attn_window: Optional[int] = None      # chunked/local attention width
    global_every: int = 0                  # 0 = no interleaving
    # norm / act
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm
    act: str = "silu"             # silu (SwiGLU) | gelu (plain 2-mat MLP)
    tie_embeddings: bool = False
    # family payloads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    # modality frontend stub ([audio]/[vlm]): inputs are precomputed embeddings
    frontend_stub: bool = False
    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # scan stacking: layers per scan super-block (set by pattern families)
    remat: str = "full"           # full | dots | none

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """vocab rounded up to 256 so the vocab dim shards cleanly."""
        return -(-self.vocab // 256) * 256

    def supports_long_context(self) -> bool:
        """True if decode state is bounded (sub-quadratic attention)."""
        if self.family == "ssm":
            return True
        if self.rglru is not None:
            return True
        # llama4-style chunked attention: bounded window on most layers;
        # the few global layers use a sequence-sharded cache.
        if self.attn_window is not None:
            return True
        return False

    def layer_pattern(self) -> tuple:
        """The repeating unit of layer kinds + the remainder tail."""
        if self.family == "ssm":
            return ("ssm",), self.n_layers, ()
        if self.rglru is not None:
            unit = self.rglru.block_pattern
            reps = self.n_layers // len(unit)
            rem = self.n_layers - reps * len(unit)
            # recurrentgemma-9b: 38 = 12*(rec,rec,attn) + (rec, rec)
            return unit, reps, tuple(unit[:rem])
        if self.global_every > 1:
            # llama4 iRoPE: (windowed, ..., windowed, global) repeated
            unit = tuple("attn_window" for _ in range(self.global_every - 1)
                         ) + ("attn_global",)
            reps = self.n_layers // len(unit)
            rem = self.n_layers - reps * len(unit)
            return unit, reps, tuple(unit[:rem])
        return ("attn",), self.n_layers, ()


# ---------------------------------------------------------------------------
# the four assigned input shapes (global, LM-family)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, ("pure full-attention arch: 524k decode needs "
                       "sub-quadratic attention (skip noted in DESIGN.md)")
    return True, ""
