"""GQA attention block: QKV projection, optional per-head qk RMSNorm (Qwen3),
RoPE, flash attention for prefill, the decode-attention kernel for
single-token steps against a static KV cache, optional sliding window.
With ``cfg.kv_cache_bits == 8`` the cache holds int8 K/V and f32 scales
(``{"k", "ks", "v", "vs"}``, the reference's leaf order) and a step attends
through the plain ``decode_attention_q8_ref``, as the reference does."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_q8_ref,
    quantize_kv,
)
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


def _int8(cfg) -> bool:
    return cfg.kv_cache_bits == 8


def init_kv_cache(cfg, batch: int, max_seq: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Zero K/V of (B, S, Hkv, Dh); with 8 bits int8 ``k``, ``v`` and f32
    (B, S, Hkv) scales ``ks``, ``vs``, in the reference's (sorted) leaf
    order: the carried pairs are matched by value, and the zero leaves of
    one dtype are byte-identical."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    if _int8(cfg):
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def prefill_kv_cache(cfg, k: torch.Tensor, v: torch.Tensor, pad: int) -> Dict[str, torch.Tensor]:
    """A prompt's (B, s, Hkv, Dh) K/V as one layer's decode cache, padded by
    ``pad`` rows, with the leaves of ``init_kv_cache`` (quantized with 8
    bits, as the reference's ``models/lm.py`` prefill does)."""
    if _int8(cfg):
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return {"k": F.pad(kq, (0, 0, 0, 0, 0, pad)), "ks": F.pad(ks, (0, 0, 0, pad)),
                "v": F.pad(vq, (0, 0, 0, 0, 0, pad)), "vs": F.pad(vs, (0, 0, 0, pad))}
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, 0, 0, pad))}


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
    kv_len = (pos.reshape(1) + 1).to(torch.int32).repeat(b)
    if _int8(cfg):
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        new = {"k": cache["k"].index_copy(1, idx, kq), "ks": cache["ks"].index_copy(1, idx, ks),
               "v": cache["v"].index_copy(1, idx, vq), "vs": cache["vs"].index_copy(1, idx, vs)}
        out = decode_attention_q8_ref(
            q.reshape(b, cfg.n_heads, cfg.d_head), new["k"], new["v"], new["ks"], new["vs"],
            kv_len, window=cfg.window,
        )
        return dense(out.reshape(b, 1, -1), p["wo"]), new
    k_cache = cache["k"].index_copy(1, idx, k)
    v_cache = cache["v"].index_copy(1, idx, v)
    out = decode_attention(
        q.reshape(b, cfg.n_heads, cfg.d_head), k_cache, v_cache, kv_len,
        window=cfg.window,
    )
    out = dense(out.reshape(b, 1, -1), p["wo"])
    return out, {"k": k_cache, "v": v_cache}
