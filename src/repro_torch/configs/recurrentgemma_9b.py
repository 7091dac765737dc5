"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 ratio.

38L d_model=4096 16H (GQA kv=1 = MQA) d_ff=12288 vocab=256000
[arXiv:2402.19427 (Griffin); unverified]. Pattern: 12 x (rec, rec, attn)
+ 2 trailing rec = 38 layers; local attention window 2048. Bounded decode
state -> runs the long_500k cell.

Copy of ``repro.configs.recurrentgemma_9b`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    rglru=RGLRUConfig(block_pattern=("rec", "rec", "attn"), window=2048,
                      conv=4),
    act="gelu",                  # Griffin uses GeGLU
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=5,                  # 1 x (rec, rec, attn) + (rec, rec)
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=512,
    rglru=RGLRUConfig(block_pattern=("rec", "rec", "attn"), window=16,
                      conv=4),
    act="gelu",
    tie_embeddings=True,
)
