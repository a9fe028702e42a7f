from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    decode_attention_cuda,
    decode_attention_ref,
)
