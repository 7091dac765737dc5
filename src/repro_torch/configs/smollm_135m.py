"""smollm-135m [dense] — llama-arch small.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]. 9 heads do not divide the 16-way model
axis -> heads replicate, d_ff shards (divisibility fallback exercised).

Copy of ``repro.configs.smollm_135m`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    act="silu",
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="smollm-135m-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_ff=96,
    vocab=512,
    act="silu",
    tie_embeddings=True,
)
