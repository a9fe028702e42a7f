"""Fused RMSNorm as one custom op: the Hopper kernel on a CUDA tensor, the
plain version on a CPU tensor.

Registered as ``repro_torch::rmsnorm`` so a traced graph keeps it as one
node, just as one ``pallas_call`` is one jaxpr equation in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm_cuda(
    x: torch.Tensor, scale: torch.Tensor, eps: float, offset: float
) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    d = x.shape[-1]
    if x.dtype != scale.dtype:
        raise TypeError(f"x is {x.dtype} but scale is {scale.dtype}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    if scale.device != x.device:
        raise ValueError("x and scale on different devices")
    dtype = library.dtype_code(x.dtype)
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    fn = library.entry("rmsnorm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    library.LAUNCHES["rmsnorm"] += 1
    library.check("rmsnorm", fn(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
        float(eps), float(offset), dtype, stream,
    ))
    return y


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm_op(
    x: torch.Tensor, scale: torch.Tensor, eps: float, offset: float
) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, offset)
    if x.device.type == "cuda":
        return rmsnorm_cuda(x, scale, eps, offset)
    raise ValueError(f"rmsnorm runs on cpu or cuda tensors, not {x.device}")


@rmsnorm_op.register_fake
def _(x, scale, eps, offset):
    return torch.empty_like(x)


def rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6, offset: float = 0.0
) -> torch.Tensor:
    return rmsnorm_op(x, scale, float(eps), float(offset))


__all__ = ["rmsnorm", "rmsnorm_ref", "rmsnorm_cuda"]
