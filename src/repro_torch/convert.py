"""Parameters of the JAX package (as numpy, ``jax.tree.map(np.asarray, p)``)
to the port's: the layouts are the same, so conversion is a dtype move."""
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
    """Convert a nested dict of numpy arrays; every leaf must have the
    config's dtype."""
    dev = resolve_device(device)
    want = getattr(torch, cfg.dtype)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = tensor_from_numpy(np.asarray(node))
        if t.dtype != want:
            raise TypeError(f"leaf dtype {t.dtype} != config dtype {want}")
        return t.to(dev)

    return conv(tree)
