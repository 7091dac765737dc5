"""falcon-mamba-7b [ssm] — attention-free mamba1 architecture.

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16
[arXiv:2410.05355; unverified]. d_inner = 2 * d_model = 8192.
O(1) decode state -> runs the long_500k cell.

Copy of ``repro.configs.falcon_mamba_7b`` for the port
(dataclass literals, not imported).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                   # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(state=16, conv=4, expand=2),
    act="silu",
)

SMOKE = ArchConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=512,
    ssm=SSMConfig(state=4, conv=4, expand=2),
    act="silu",
)
