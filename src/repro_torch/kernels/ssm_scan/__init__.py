from repro_torch.kernels.ssm_scan.ops import (
    gated_scan,
    gated_scan_cuda,
    gated_scan_mma_ref,
    gated_scan_padded,
    gated_scan_ref,
    gated_step,
    gated_step_ref,
    scan_plan,
    ssm_scan,
    ssm_scan_ref,
    ssm_step,
    ssm_step_ref,
)
