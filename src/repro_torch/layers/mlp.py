"""Dense FFN block: SwiGLU (LLaMA-style) gated MLP."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.layers.common import dense, dense_init


def mlp_init(
    gen: torch.Generator, d_model: int, d_ff: int, dtype, layers: int
) -> Dict[str, torch.Tensor]:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, layers=layers),
        "w_up": dense_init(gen, d_model, d_ff, dtype, layers=layers),
        "w_down": dense_init(gen, d_ff, d_model, dtype, layers=layers),
    }


def mlp_specs() -> Dict[str, P]:
    return {
        "w_gate": P(None, "tp"),
        "w_up": P(None, "tp"),
        "w_down": P("tp", None),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    g = F.silu(dense(x, p["w_gate"]).float()).to(x.dtype)
    u = dense(x, p["w_up"])
    return dense(g * u, p["w_down"])
