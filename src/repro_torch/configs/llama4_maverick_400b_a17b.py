"""llama4-maverick-400b-a17b [hf:meta-llama; unverified]: 48L d5120 40H(GQA
kv=8) ff8192 v202048, MoE 128 experts top-1 interleaved (every 2nd layer),
shared expert; the text backbone (the early-fusion frontend is not part of
the model here, as in the reference)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=202048,
    moe_experts=128,
    moe_top_k=1,
    moe_every=2,            # interleaved dense/MoE
    moe_shared_expert=True,
    rope_theta=5e5,
)
