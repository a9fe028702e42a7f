"""Device resolution and host payloads shared by the port's entry points.

The entry points run on the card unless the caller asks for the CPU; asking
for the card where there is none raises instead of falling back.  Host-side
values (what the application uploads and downloads) are CPU tensors: bf16 has
no numpy dtype, so numpy cannot be the wire format.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def resolve_device(device: Any = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def to_host(x: Any) -> torch.Tensor:
    """A host (CPU) tensor for an application value.  A CPU tensor is
    returned as the same object, so a handle the application threads back
    keeps its identity."""
    if isinstance(x, torch.Tensor):
        return x if x.device.type == "cpu" else x.cpu()
    return torch.from_numpy(np.array(x, copy=True))
