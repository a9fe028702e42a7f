"""zamba2-1.2b [arXiv:2411.15242]: 38 Mamba2 blocks d2048 ssm_state 64 +
ONE shared attention(+MLP) block (32H, d_head 64) applied every 6 blocks,
ff8192 v32000."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=6,
    rope_theta=1e4,
)
