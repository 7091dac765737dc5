"""granite-8b [dense] — llama-arch code model.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152 [arXiv:2405.04324; hf].

Copy of ``repro.configs.granite_8b`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    act="silu",
)

SMOKE = ArchConfig(
    name="granite-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    act="silu",
)
