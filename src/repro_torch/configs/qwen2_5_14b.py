"""qwen2.5-14b [dense] — GQA + QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064
[hf:Qwen/Qwen2.5 family; hf].

Copy of ``repro.configs.qwen2_5_14b`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    act="silu",
)

SMOKE = ArchConfig(
    name="qwen2.5-14b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    qkv_bias=True,
    act="silu",
)
