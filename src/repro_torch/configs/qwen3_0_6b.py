"""qwen3-0.6b [dense] — qk_norm + GQA.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936
[hf:Qwen/Qwen3-8B family; hf]. head_dim=128 (> d_model/n_heads).

Copy of ``repro.configs.qwen3_0_6b`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    act="silu",
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen3-0.6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    head_dim=32,
    qk_norm=True,
    act="silu",
    tie_embeddings=True,
)
