from repro_torch.kernels.rmsnorm.ops import (
    rmsnorm,
    rmsnorm_backward_cuda,
    rmsnorm_backward_op,
    rmsnorm_backward_plan,
    rmsnorm_backward_ref,
    rmsnorm_cuda,
    rmsnorm_plan,
    rmsnorm_ref,
)
