"""xlstm-1.3b [arXiv:2405.04517]: 48 blocks d2048, 4 heads, d_ff=0 (gated
projection blocks instead of MLP), sLSTM every 8th block ([7:1] ratio),
v50304."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_head=512,
    d_ff=0,
    vocab=50304,
    ssm_chunk=128,
    slstm_every=8,
    slstm_ff=2736,          # ~4/3 * d_model, rounded to /16
)
