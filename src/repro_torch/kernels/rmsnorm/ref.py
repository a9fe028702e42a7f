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


def rmsnorm_backward_ref(
    dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
    offset: float = 0.0,
) -> tuple:
    """(dx, dscale) of :func:`rmsnorm_ref` for the cotangent ``dy``, in f32
    and returned in x's and scale's dtypes.  With r = rsqrt(mean(x^2) + eps)
    and g = dy * (offset + scale): dx = r * (g - x r * mean(g * x r)), and
    dscale sums dy * x r over every row."""
    d = x.shape[-1]
    xf, gf = x.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xn = xf * r
    g = gf * (offset + scale.float())
    dx = r * (g - xn * (g * xn).mean(dim=-1, keepdim=True))
    dscale = (gf * xn).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
