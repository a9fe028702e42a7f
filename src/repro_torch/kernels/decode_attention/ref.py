"""Plain PyTorch version of decode attention (one new token vs a KV cache),
mirroring ``repro/kernels/decode_attention/ref.py::decode_attention_ref``.

q: (B, Hq, D) — a single query position per sequence;
k_cache, v_cache: (B, S, Hkv, D) — statically-shaped cache;
kv_len: (B,) int32 — number of valid cache entries per sequence (positions
>= kv_len are masked out); optionally only the last ``window`` positions
attend.  ``decode_attention_q8_ref`` and ``quantize_kv`` are the int8
cache's plain functions; the reference has no Pallas kernel for them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def decode_attention_split_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    window: Optional[int] = None,
    split: int = 64,
) -> torch.Tensor:
    """The split-KV kernel's arithmetic in plain PyTorch: the cache is cut
    into ceil(S / split) splits of ``split`` positions; each split keeps its
    own max m, sum l and unnormalised P.V acc over its valid keys (an empty
    split has l = 0), and the splits merge in split order as
    sum acc e^(m - M) / sum l e^(m - M), empty splits skipped.  Used by the
    tests and the smoke run, never by the op."""
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    n_rep = hq // hkv
    n_split = -(-s // split)
    scale = 1.0 / float(d) ** 0.5
    pad = n_split * split - s
    kf = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.reshape(b, n_split, split, hkv, d)
    vf = vf.reshape(b, n_split, split, hkv, d)
    qf = q.float().reshape(b, hkv, n_rep, d)
    sc = torch.einsum("bgrd,bzjgd->bgrzj", qf, kf) * scale     # (B, Hkv, R, Z, L)
    pos = torch.arange(n_split * split, device=q.device).reshape(n_split, split)
    lens = torch.clamp(kv_len.to(torch.int64), max=s)[:, None, None]
    ok = pos[None] < lens
    if window is not None:
        ok &= pos[None] >= lens - window
    ok = ok[:, None, None]                                      # (B, 1, 1, Z, L)
    m = torch.where(ok, sc, NEG_INF).amax(dim=-1)               # (B, Hkv, R, Z)
    p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bgrzj,bzjgd->bgrzd", p, vf)
    live = l > 0
    big_m = torch.where(live, m, NEG_INF).amax(dim=-1, keepdim=True)
    a = torch.where(live, torch.exp(m - big_m), 0.0)
    out = (acc * a[..., None]).sum(dim=-2) / torch.clamp((l * a).sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_q8_ref(
    q: torch.Tensor,          # (B, Hq, D)
    k_q: torch.Tensor,        # (B, S, Hkv, D) int8
    v_q: torch.Tensor,        # (B, S, Hkv, D) int8
    k_s: torch.Tensor,        # (B, S, Hkv) f32 per-position, per-head scales
    v_s: torch.Tensor,
    kv_len: torch.Tensor,     # (B,)
    *,
    window: Optional[int] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Decode attention over an int8 cache (``decode_attention_q8_ref`` of
    the reference): the cache is padded to a multiple of ``chunk = min(chunk,
    S)`` positions and a streaming softmax runs over the chunks, each chunk
    dequantized to f32 on its own.  The reference's ``lax.scan`` over the
    chunks is a Python loop here: one chunk at the served buckets."""
    b, hq, d = q.shape
    _, s, hkv, _ = k_q.shape
    n_rep = hq // hkv
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        k_q = F.pad(k_q, (0, 0, 0, 0, 0, pad))
        v_q = F.pad(v_q, (0, 0, 0, 0, 0, pad))
        k_s = F.pad(k_s, (0, 0, 0, pad))
        v_s = F.pad(v_s, (0, 0, 0, pad))
    scale = 1.0 / float(d) ** 0.5
    qf = q.float().reshape(b, hkv, n_rep, d)
    lens = kv_len.to(torch.int64)[:, None]
    m = torch.full((b, hkv, n_rep), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, n_rep), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, hkv, n_rep, d), dtype=torch.float32, device=q.device)
    for start in range(0, s + pad, chunk):
        rows = slice(start, start + chunk)
        kf = k_q[:, rows].float() * k_s[:, rows, :, None]          # (B, chunk, Hkv, D)
        vf = v_q[:, rows].float() * v_s[:, rows, :, None]
        sm = torch.einsum("bgrd,bcgd->bgrc", qf, kf) * scale      # (B, Hkv, R, chunk)
        pos = start + torch.arange(chunk, device=q.device)[None, :]
        ok = pos < lens
        if window is not None:
            ok &= pos >= lens - window
        sm = torch.where(ok[:, None, None, :], sm, NEG_INF)
        m_new = torch.maximum(m, sm.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sm - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bgrc,bcgd->bgrd", p, vf)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def quantize_kv(x: torch.Tensor):
    """(..., D) -> int8 values and the per-(...) f32 scale max|x| / 127 +
    1e-8; rounding half to even, as ``jnp.round``."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s
