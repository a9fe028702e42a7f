"""mixtral-8x7b [arXiv:2401.04088]: 32L d4096 32H(GQA kv=8) ff14336 v32000,
MoE 8 experts top-2, sliding-window attention (4096)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=32000,
    moe_experts=8,
    moe_top_k=2,
    moe_every=1,
    window=4096,
    rope_theta=1e6,
)
