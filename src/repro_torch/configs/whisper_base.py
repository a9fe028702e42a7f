"""whisper-base [arXiv:2212.04356]: enc-dec 6L+6L d512 8H ff2048 v51865,
conv frontend STUB (the caller supplies 1500 frame embeddings).  The
decoder is capped at 448 positions."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab=51865,
    enc_layers=6,
    dec_layers=6,
    enc_seq=1500,
    max_target_positions=448,
    skip_shapes=("long_500k",),
)
