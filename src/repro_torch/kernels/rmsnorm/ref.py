"""Plain PyTorch version of fused RMSNorm (mirrors
``repro/kernels/rmsnorm/ref.py::rmsnorm_ref``)."""
from __future__ import annotations

import torch


def rmsnorm_ref(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, offset: float = 0.0
) -> torch.Tensor:
    """y = x / rms(x) * (offset + scale), reduced over the trailing dim in f32.
    ``offset=1.0`` gives the Gemma/zero-centered-scale convention."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (offset + scale.float())).to(x.dtype)
