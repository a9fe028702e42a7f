"""deepseek-67b [arXiv:2401.02954]: 95L d8192 64H(GQA kv=8) ff22016 v102400,
dense llama-arch."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab=102400,
    rope_theta=1e4,
    skip_shapes=("long_500k",),
)
