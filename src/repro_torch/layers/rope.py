"""Rotary position embeddings (RoPE), position-indexed so the same code path
serves prefill (positions = arange) and decode (a position tensor per
sequence).  Positions stay tensors, so a traced decode step never bakes one
in."""
from __future__ import annotations

import torch


def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies (d_head/2,)."""
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exponent)


def apply_rope(
    x: torch.Tensor,          # (B, S, H, D)
    positions: torch.Tensor,  # (B, S) int
    theta: float = 1e6,
) -> torch.Tensor:
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions.float()[..., None] * inv              # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
