"""llava-next-34b [hf:llava-hf; unverified]: 60L d7168 56H(GQA kv=8) ff20480
v64000 — transformer backbone; the anyres vision tower is a STUB (the
caller supplies 576 precomputed patch embeddings)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    num_patches=576,
    rope_theta=5e6,
    skip_shapes=("long_500k",),
)
