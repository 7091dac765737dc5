"""llama4-scout-17b-a16e [moe] — MoE 16e top-1 + shared expert, iRoPE.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. iRoPE: 3 chunked-
attention layers (window 8192, RoPE) then 1 global layer (NoPE), repeated;
every layer is MoE with a shared expert. Bounded window on 3/4 of layers
+ sequence-sharded cache on global layers -> runs the long_500k cell.

Copy of ``repro.configs.llama4_scout_17b_a16e`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=MoEConfig(n_experts=16, top_k=1, shared_expert=True),
    attn_window=8192,
    global_every=4,              # (w, w, w, global) repeating
    rope_theta=5e5,
    act="silu",
)

SMOKE = ArchConfig(
    name="llama4-scout-17b-a16e-smoke",
    family="moe",
    n_layers=4,                  # one full (w, w, w, g) unit
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    moe=MoEConfig(n_experts=4, top_k=1, shared_expert=True,
                  capacity_factor=4.0),
    attn_window=16,
    global_every=4,
    act="silu",
)
