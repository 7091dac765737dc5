"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4
[hf:databricks/dbrx-base; unverified].

Copy of ``repro.configs.dbrx_132b`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4),
    act="silu",
)

SMOKE = ArchConfig(
    name="dbrx-132b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0),
    act="silu",
)
