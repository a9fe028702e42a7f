from repro_torch.kernels.flash_attention.ops import (
    attention_chunked,
    attention_dense,
    flash_attention,
    flash_attention_cuda,
    packed_row,
    tile_plan,
)
