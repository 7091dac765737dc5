"""seamless-m4t-medium [audio] — enc-dec multimodal backbone.

12L d_model=1024 16H (GQA kv=16 = MHA) d_ff=4096 vocab=256206
[arXiv:2308.11596; hf]. The speech frontend is a STUB: input_specs()
provides precomputed frame embeddings (frontend_dim x frontend_len) to the
encoder; the text decoder is a standard transformer with cross-attention.

Copy of ``repro.configs.seamless_m4t_medium`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                 # decoder layers; encoder in EncoderConfig
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    norm_kind="layernorm",
    act="gelu",
    rope_kind="none",            # learned/sinusoidal positions; stubbed as none
    encoder=EncoderConfig(n_layers=12, frontend_dim=1024, frontend_len=1024),
    frontend_stub=True,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    norm_kind="layernorm",
    act="gelu",
    rope_kind="none",
    encoder=EncoderConfig(n_layers=2, frontend_dim=64, frontend_len=32),
    frontend_stub=True,
    tie_embeddings=True,
)
