"""GQA attention block: QKV projection, optional per-head qk RMSNorm (Qwen3),
RoPE, flash attention for prefill, the decode-attention kernel for
single-token steps against a static KV cache, optional sliding window."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.layers.common import dense, dense_init
from repro_torch.layers.rope import apply_rope


def attn_init(gen: torch.Generator, cfg, dtype, layers: int) -> Dict[str, torch.Tensor]:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(gen, d, hq * dh, dtype, layers=layers),
        "wk": dense_init(gen, d, hkv * dh, dtype, layers=layers),
        "wv": dense_init(gen, d, hkv * dh, dtype, layers=layers),
        "wo": dense_init(gen, hq * dh, d, dtype, layers=layers),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((layers, dh), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((layers, dh), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense(x, p["wq"]).reshape(b, s, hq, dh)
    k = dense(x, p["wk"]).reshape(b, s, hkv, dh)
    v = dense(x, p["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], eps=cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                    # (B, S, D)
    cfg,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    return_kv: bool = False,
):
    """Prefill path (full sequence, flash attention)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v, causal=causal, window=cfg.window)
    out = dense(out.reshape(b, s, -1), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def init_kv_cache(cfg, batch: int, max_seq: int, dtype, device) -> Dict[str, torch.Tensor]:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attn_decode_step(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                       # (B, 1, D)
    cache: Dict[str, torch.Tensor],        # k/v (B, S, Hkv, Dh)
    pos: torch.Tensor,                     # 0-d int32 — current length (uniform)
    cfg,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token against the cache.  ``pos`` stays a tensor throughout (the
    cache write is an ``index_copy`` at a tensor index and the kernel takes
    ``kv_len`` as a tensor), so a traced step is correct at every position.
    The write is out of place: the step returns a new cache."""
    b = x.shape[0]
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(p, x, cfg, positions)
    idx = pos.reshape(1).long()
    k_cache = cache["k"].index_copy(1, idx, k)
    v_cache = cache["v"].index_copy(1, idx, v)
    kv_len = (pos.reshape(1) + 1).to(torch.int32).repeat(b)
    out = decode_attention(
        q.reshape(b, cfg.n_heads, cfg.d_head), k_cache, v_cache, kv_len,
        window=cfg.window,
    )
    out = dense(out.reshape(b, 1, -1), p["wo"])
    return out, {"k": k_cache, "v": v_cache}
