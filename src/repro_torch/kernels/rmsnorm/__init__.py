from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_cuda, rmsnorm_plan, rmsnorm_ref
