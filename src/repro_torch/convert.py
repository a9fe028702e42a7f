"""Parameters of the JAX package (as numpy, ``jax.tree.map(np.asarray, p)``)
to the port's.  The LM layouts are the same, so their conversion is a dtype
move; the CNN zoo's convolution kernels go from HWIO to torch's OIHW."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with the same bits; numpy's bfloat16 (ml_dtypes) travels
    as its 16-bit pattern, since torch cannot read that dtype."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, device: Any = "cuda"):
    """Convert a nested dict of numpy arrays.  Each leaf keeps its own dtype,
    which must be the config's or float32 (the reference keeps a Mamba2
    block's ``A_log``, ``D`` and ``dt_bias`` in f32 in a bf16 model); any
    other dtype raises."""
    dev = resolve_device(device)
    allowed = {getattr(torch, cfg.dtype), torch.float32}

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = tensor_from_numpy(np.asarray(node))
        if t.dtype not in allowed:
            raise TypeError(f"leaf dtype {t.dtype} is neither the config's "
                            f"{cfg.dtype} nor float32")
        return t.to(dev)

    return conv(tree)


def cnn_params_from_numpy(params: Dict[str, Any], device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """Convert a CNN zoo model's flat dict of numpy arrays.  Every 4-dim leaf
    is a convolution kernel in the reference's HWIO layout (the depthwise
    ``*_dw`` kernels ``(7, 7, 1, dim)`` included) and becomes torch's OIHW
    through ``permute(3, 2, 0, 1)``; every other leaf is carried as is."""
    dev = resolve_device(device)
    out = {}
    for name, arr in params.items():
        t = tensor_from_numpy(np.asarray(arr))
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        out[name] = t.to(dev)
    return out
