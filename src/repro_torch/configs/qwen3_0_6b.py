"""qwen3-0.6b [hf:Qwen/Qwen3]: 28L d1024 16H(GQA kv=8) ff3072 v151936,
qk-norm, head_dim 128, tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
