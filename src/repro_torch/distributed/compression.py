"""Gradient compression: int8-quantized all-reduce with error feedback
(``repro.distributed.compression`` over ``torch.distributed``).

Each rank quantizes its gradient to int8 with a per-tensor scale, the int8
payload is all-reduced (as int32, so the sum cannot wrap), and the
quantization residual is carried into the next step (error feedback).

The arithmetic is the reference's, step for step: the payload, the scales
and the rank count are summed, and the mean is
``summed * (scale_sum / n) / n``.  That multiplies every rank's ``q`` by the
*mean* scale, not by its own, so where the ranks' scales differ it is not
the mean of the dequantized values the reference's comment names (ROADMAP
queue C).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.training.optimizer import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, group=None, error: Optional[torch.Tensor] = None):
    """int8 all-reduce with error feedback over ``group`` (the default
    group when None).  Returns (mean-reduced value, new error residual)."""
    if error is not None:
        x = x + error
    q, scale = quantize_int8(x)
    new_error = x - dequantize_int8(q, scale)
    summed = q.to(torch.int32)
    scale_sum = scale.clone()
    n = torch.ones((), dtype=torch.float32, device=x.device)
    for t in (summed, scale_sum, n):
        dist.all_reduce(t, group=group)
    mean = summed.to(torch.float32) * (scale_sum / n) / n
    return mean, new_error


def make_compressed_grad_psum(mesh, axis_name: str = "data"):
    """Data-parallel gradient mean with int8 compression, leaf by leaf over
    a gradient dict that is replicated along ``axis_name`` of the live
    ``mesh``.  Returns ``reduce_tree(grads, errors) -> (means, errors)``."""
    group = mesh.group(axis_name)

    def reduce_tree(grads: Dict[str, Any], errors: Dict[str, Any]):
        means, new_errors = {}, {}
        for key in grads:  # the same order on every rank: the dict's
            if isinstance(grads[key], dict):
                means[key], new_errors[key] = reduce_tree(grads[key], errors[key])
            else:
                means[key], new_errors[key] = compressed_psum(
                    grads[key].to(torch.float32), group, errors[key]
                )
        return means, new_errors

    return reduce_tree


def init_error_state(grads_shape_tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=torch.float32,
                              device=getattr(s, "device", None)),
        grads_shape_tree,
    )
