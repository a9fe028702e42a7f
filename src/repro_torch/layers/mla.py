"""Multi-head Latent Attention (MLA, DeepSeek-V2 / MiniCPM3), with its
partition specs (``repro.layers.mla``).

KV is compressed into a low-rank latent c_kv (kv_lora) plus one shared RoPE
key head; the decode cache stores only (c_kv, k_rope), ~(kv_lora + rope) per
position instead of 2 * H * d_head.

* prefill / forward: the latents are expanded to per-head K/V and run
  through one flash-attention call at the qk head dim (nope + rope; 96 for
  minicpm3-4b), V zero-padded from v_head_dim up to it, as the reference
  does;
* decode: the *absorbed* form, W^UK folded into the query and W^UV into the
  output, so attention runs in latent space (plain torch, scores and softmax
  in f32: the reference has no kernel for it either).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.layers.common import dense, dense_init
from repro_torch.layers.rope import apply_rope

NEG_INF = -1e30


def mla_init(gen: torch.Generator, cfg, dtype, layers: int) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    dev = gen.device
    return {
        "wq_a": dense_init(gen, d, cfg.q_lora, dtype, layers=layers),
        "q_a_norm": torch.ones((layers, cfg.q_lora), dtype=dtype, device=dev),
        "wq_b": dense_init(gen, cfg.q_lora, h * qk, dtype, layers=layers),
        "wkv_a": dense_init(gen, d, cfg.kv_lora + cfg.rope_head_dim, dtype, layers=layers),
        "kv_a_norm": torch.ones((layers, cfg.kv_lora), dtype=dtype, device=dev),
        "wkv_b": dense_init(gen, cfg.kv_lora, h * (cfg.nope_head_dim + cfg.v_head_dim), dtype,
                            layers=layers),
        "wo": dense_init(gen, h * cfg.v_head_dim, d, dtype, layers=layers),
    }


def mla_specs(cfg) -> Dict[str, P]:
    return {
        "wq_a": P(None, None),
        "q_a_norm": P(None),
        "wq_b": P(None, "tp"),
        "wkv_a": P(None, None),
        "kv_a_norm": P(None),
        "wkv_b": P(None, "tp"),
        "wo": P("tp", None),
    }


def _queries(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    b, s, _ = x.shape
    q = dense(rmsnorm(dense(x, p["wq_a"]), p["q_a_norm"], eps=cfg.norm_eps), p["wq_b"])
    q = q.reshape(b, s, cfg.n_heads, cfg.nope_head_dim + cfg.rope_head_dim)
    q_nope, q_rope = torch.split(q, [cfg.nope_head_dim, cfg.rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """(c_kv (B,S,kv_lora), k_rope (B,S,rope)); the norm's kernel takes a
    contiguous row, so the latent half of the projection is copied out."""
    kv_a = dense(x, p["wkv_a"])
    c_kv, k_rope = torch.split(kv_a, [cfg.kv_lora, cfg.rope_head_dim], dim=-1)
    c_kv = rmsnorm(c_kv.contiguous(), p["kv_a_norm"], eps=cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_forward(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                    # (B, S, D)
    cfg,
    *,
    positions: Optional[torch.Tensor] = None,
    return_kv: bool = False,
):
    """Prefill: latents expanded to per-head K/V, one causal flash call at
    the qk head dim.  K is ``[k_nope | k_rope]`` with the shared rope head
    broadcast over the heads; V is zero-padded up to the qk head dim and the
    padded output columns are dropped."""
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)

    kv = dense(c_kv, p["wkv_b"]).reshape(b, s, h, cfg.nope_head_dim + cfg.v_head_dim)
    k_nope, v = torch.split(kv, [cfg.nope_head_dim, cfg.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, cfg.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    qk_dim = cfg.nope_head_dim + cfg.rope_head_dim
    v_pad = F.pad(v, (0, qk_dim - cfg.v_head_dim))
    out = flash_attention(q, k, v_pad, causal=True)
    out = dense(out[..., : cfg.v_head_dim].reshape(b, s, -1), p["wo"])
    if return_kv:
        return out, (c_kv, k_rope)
    return out


def init_mla_cache(cfg, batch: int, max_seq: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.rope_head_dim), dtype=dtype, device=device),
    }


def mla_cache_specs(cfg) -> Dict[str, P]:
    return {"c_kv": P(None, "dp", None), "k_rope": P(None, "dp", None)}


def mla_decode_step(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                       # (B, 1, D)
    cache: Dict[str, torch.Tensor],        # c_kv (B, S, C), k_rope (B, S, R)
    pos: torch.Tensor,                     # 0-d int32 — current length (uniform)
    cfg,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-matrix decode: attention in latent space.  ``pos`` stays a
    tensor (the cache write is an ``index_copy``, the mask a comparison with
    it), so a traced step is correct at every position; the write is out of
    place, as the GQA step's is."""
    b = x.shape[0]
    h = cfg.n_heads
    f32 = torch.float32
    positions = pos.reshape(1, 1).expand(b, 1)
    q_nope, q_rope = _queries(p, x, cfg, positions)        # (B,1,H,·)
    c_kv_new, k_rope_new = _latents(p, x, cfg, positions)
    idx = pos.reshape(1).long()
    c_cache = cache["c_kv"].index_copy(1, idx, c_kv_new)
    r_cache = cache["k_rope"].index_copy(1, idx, k_rope_new)

    # absorb W^UK into q:  q_lat[b,h,c] = sum_n q_nope[b,h,n] * W_k[c,h,n]
    w_kv_b = p["wkv_b"].reshape(cfg.kv_lora, h, cfg.nope_head_dim + cfg.v_head_dim)
    w_k = w_kv_b[:, :, : cfg.nope_head_dim]               # (C, H, N)
    w_v = w_kv_b[:, :, cfg.nope_head_dim:]                # (C, H, V)
    q_lat = torch.einsum("bhn,chn->bhc", q_nope[:, 0], w_k)

    s_len = c_cache.shape[1]
    scale = 1.0 / float(cfg.nope_head_dim + cfg.rope_head_dim) ** 0.5
    scores = (
        torch.einsum("bhc,bsc->bhs", q_lat.to(f32), c_cache.to(f32))
        + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].to(f32), r_cache.to(f32))
    ) * scale
    valid = torch.arange(s_len, device=x.device) < (pos + 1)
    scores = torch.where(valid[None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhs,bsc->bhc", probs, c_cache.to(f32))
    out = torch.einsum("bhc,chv->bhv", o_lat, w_v.to(f32))
    out = dense(out.reshape(b, 1, -1).to(x.dtype), p["wo"])
    return out, {"c_kv": c_cache, "k_rope": r_cache}
