"""minicpm3-4b [hf:openbmb/MiniCPM3-4B]: 62L d2560 40H ff6400 v73448, MLA
(q_lora 768, kv_lora 256, nope 64, rope 32, v 64)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=96,              # nope + rope qk head dim
    d_ff=6400,
    vocab=73448,
    attn_kind="mla",
    q_lora=768,
    kv_lora=256,
    rope_head_dim=32,
    nope_head_dim=64,
    v_head_dim=64,
    rope_theta=1e4,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
