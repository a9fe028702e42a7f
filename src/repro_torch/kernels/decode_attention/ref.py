"""Plain PyTorch version of decode attention (one new token vs a KV cache),
mirroring ``repro/kernels/decode_attention/ref.py::decode_attention_ref``.

q: (B, Hq, D) — a single query position per sequence;
k_cache, v_cache: (B, S, Hkv, D) — statically-shaped cache;
kv_len: (B,) int32 — number of valid cache entries per sequence (positions
>= kv_len are masked out); optionally only the last ``window`` positions
attend.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    n_rep = hq // hkv
    scale = 1.0 / float(d) ** 0.5

    kf = k_cache.float()
    vf = v_cache.float()
    qf = q.float().reshape(b, hkv, n_rep, d)
    s_mat = torch.einsum("bgrd,bsgd->bgrs", qf, kf) * scale   # (B, Hkv, n_rep, S)
    pos = torch.arange(s, device=q.device)[None, :]           # (1, S)
    lens = kv_len.to(torch.int64)[:, None]
    ok = pos < lens
    if window is not None:
        ok &= pos >= lens - window
    s_mat = torch.where(ok[:, None, None, :], s_mat, NEG_INF)
    p = torch.softmax(s_mat, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, vf)
    return out.reshape(b, hq, d).to(q.dtype)
