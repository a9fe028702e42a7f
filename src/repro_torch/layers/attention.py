"""GQA attention block: QKV projection, optional per-head qk RMSNorm (Qwen3),
RoPE, flash attention for prefill, the decode-attention kernel for
single-token steps against a static KV cache, optional sliding window.
With ``cfg.kv_cache_bits == 8`` the cache holds int8 K/V and f32 scales
(``{"k", "ks", "v", "vs"}``, the reference's leaf order) and a step attends
through the plain ``decode_attention_q8_ref``, as the reference does.
With ``cfg.sp_decode`` under a live mesh with a "model" axis, a decode step
is sequence-parallel (``_sp_decode_attention``): each rank holds its S/tp
slice of the cache."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import live_mesh
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


def attn_specs(cfg) -> Dict[str, P]:
    s = {
        "wq": P(None, "tp"),
        "wk": P(None, "tp"),
        "wv": P(None, "tp"),
        "wo": P("tp", None),
    }
    if cfg.qk_norm:
        s["q_norm"] = P(None)
        s["k_norm"] = P(None)
    return s


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


def kv_cache_specs(cfg) -> Dict[str, P]:
    # long-context decode: shard the cache sequence dim over dp when batch
    # cannot fill it (SP); heads over tp when divisible
    return {"k": P(None, "dp", "tp", None), "v": P(None, "dp", "tp", None)}


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


def sp_decode_specs(batch: int, mesh) -> Tuple[P, P, P]:
    """(q, K/V cache, kv_len) layouts of the sequence-parallel decode: the
    cache sequence over "model"; the batch over the dp axes only when it
    is at least 16, as in the reference."""
    dp = mesh.dp_axes() if batch >= 16 else None
    return P(dp, None, None), P(dp, "model", None, None), P(dp)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over a batch, the products accumulated and returned in f32
    (the reference's ``preferred_element_type``).  On the card a bf16
    operand is read as it is, with no f32 copy (a strided operand is read
    in place); on the CPU it is widened first, which is exact."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _sp_decode_attention(q, k_cache, v_cache, kv_len, cfg, mesh) -> torch.Tensor:
    """Distributed flash-decode (the reference's ``shard_map`` body) on this
    rank's blocks of ``sp_decode_specs``: q (B_l, Hq, D), K/V (B_l, S/tp,
    Hkv, D) and kv_len (B_l,).  Each rank computes a local streaming-softmax
    partial (m, l, o) over its cache slice in plain torch, masked by
    kv_len and the window, and the combine is one all-reduce MAX of m and
    SUM of l * corr and o * corr over "model": the split-KV reduce across
    ranks.  Products accumulate in f32 (the reference's
    ``preferred_element_type``) one KV head at a time, reading the cache
    slice in its own dtype; the probabilities are rounded to V's dtype
    before the PV product, as the reference's are."""
    import torch.distributed as dist

    b, hq, d = q.shape
    s_local, hkv = k_cache.shape[1], k_cache.shape[2]
    n_rep = hq // hkv
    group = mesh.group("model")
    start = mesh.coordinate("model") * s_local
    scale = 1.0 / float(d) ** 0.5
    qk = q.reshape(b, hkv, n_rep, d).to(k_cache.dtype)
    sm = torch.stack([_bmm_f32(qk[:, g], k_cache[:, :, g].transpose(1, 2))
                      for g in range(hkv)], 1) * scale           # (B, g, r, S_l)
    pos = start + torch.arange(s_local, device=q.device)[None, :]
    kvl = kv_len.to(pos.dtype)[:, None]
    ok = pos < kvl
    if cfg.window is not None:
        ok &= pos >= kvl - cfg.window
    sm = torch.where(ok[:, None, None, :], sm, torch.full_like(sm, -1e30))
    m_loc = sm.amax(-1)                                          # (B, g, r)
    p = torch.exp(sm - m_loc[..., None])
    l_loc = p.sum(-1)
    pv = p.to(v_cache.dtype)
    o_loc = torch.stack([_bmm_f32(pv[:, g], v_cache[:, :, g]) for g in range(hkv)], 1)
    m_g = m_loc.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m_loc - m_g)
    l_g = l_loc * corr
    o_g = o_loc * corr[..., None]
    dist.all_reduce(l_g, group=group)
    dist.all_reduce(o_g, group=group)
    out = o_g / torch.clamp(l_g, min=1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def _sp_write(cache: torch.Tensor, row: torch.Tensor, idx: torch.Tensor, mesh) -> torch.Tensor:
    """Write one position's row into this rank's (B, S/tp, ...) slice: the
    rank whose slice holds ``idx`` writes it there; every other rank writes
    its own row back, at the clamped index (no host read of ``idx``)."""
    s_local = cache.shape[1]
    local = idx - mesh.coordinate("model") * s_local
    at = torch.clamp(local, 0, s_local - 1)
    mine = (local >= 0) & (local < s_local)
    return cache.index_copy(1, at, torch.where(mine, row, cache.index_select(1, at)))


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
    mesh = live_mesh()
    if cfg.sp_decode and mesh is not None and "model" in mesh.axis_names:
        # the cache is this rank's slice of a length tp divides
        k_cache = _sp_write(cache["k"], k, idx, mesh)
        v_cache = _sp_write(cache["v"], v, idx, mesh)
        out = _sp_decode_attention(
            q.reshape(b, cfg.n_heads, cfg.d_head), k_cache, v_cache, kv_len, cfg, mesh,
        )
    else:
        k_cache = cache["k"].index_copy(1, idx, k)
        v_cache = cache["v"].index_copy(1, idx, v)
        out = decode_attention(
            q.reshape(b, cfg.n_heads, cfg.d_head), k_cache, v_cache, kv_len,
            window=cfg.window,
        )
    out = dense(out.reshape(b, 1, -1), p["wo"])
    return out, {"k": k_cache, "v": v_cache}
