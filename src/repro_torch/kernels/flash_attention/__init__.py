from repro_torch.kernels.flash_attention.ops import (
    attention_chunked,
    attention_chunked_backward,
    attention_dense,
    backward_plan,
    flash_attention,
    flash_attention_backward_cuda,
    flash_attention_backward_op,
    flash_attention_cuda,
    packed_row,
    tile_plan,
)
