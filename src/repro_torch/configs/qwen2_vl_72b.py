"""qwen2-vl-72b [vlm] — M-RoPE + dynamic resolution (backbone only).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064
[arXiv:2409.12191; hf]. Vision frontend is a STUB: input_specs() provides
precomputed patch embeddings + 3-axis (temporal, h, w) position ids for
M-RoPE; the backbone is the standard qwen2 decoder with QKV bias.

Copy of ``repro.configs.qwen2_vl_72b`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    act="silu",
    frontend_stub=True,
)

SMOKE = ArchConfig(
    name="qwen2-vl-72b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    qkv_bias=True,
    rope_kind="mrope",
    mrope_sections=(4, 2, 2),
    act="silu",
    frontend_stub=True,
)
