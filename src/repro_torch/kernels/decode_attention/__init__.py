from repro_torch.kernels.decode_attention.ops import (
    SPLIT_LEN,
    decode_attention,
    decode_attention_cuda,
    decode_attention_ref,
    decode_attention_split_ref,
    split_plan,
)
from repro_torch.kernels.decode_attention.ref import decode_attention_q8_ref, quantize_kv
