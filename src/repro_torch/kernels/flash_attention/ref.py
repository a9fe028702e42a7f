"""Plain PyTorch versions of flash attention, mirroring
``repro/kernels/flash_attention/ref.py``:

* :func:`attention_dense` — O(S^2) materialized-scores reference;
* :func:`attention_chunked` — O(S) streaming-softmax reference with the same
  blockwise math as the kernel; the op's plain version on a CPU tensor;
* :func:`attention_chunked_backward` — its vjp, the backward op's plain
  version, and :func:`attention_backward_bf16_products`, the same with the
  bf16 kernel's roundings (a witness of its numerics, not a plain version).

Both take q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) and support causal
masking with ``q_offset``, sliding windows, GQA head grouping and logit
soft-capping.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)"""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _mask_bias(
    q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: Optional[int]
) -> torch.Tensor:
    """(Sq, Sk) additive mask bias."""
    ok = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF)


def attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Materialized-scores reference; ``q_offset`` places the queries at
    absolute positions [q_offset, q_offset+Sq) against keys at [0, Sk)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    n_rep = hq // hkv
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    # sqrt(d) is rounded through q's dtype, as the reference does (a host
    # scalar: the plain version launches nothing but its own products)
    scale = (1.0 / torch.sqrt(torch.tensor(float(d), dtype=q.dtype)).float()).item()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_cap is not None:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)[None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Streaming-softmax reference: scans KV in chunks keeping the running
    (max, denom, weighted-sum) triple."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    n_rep = hq // hkv
    kv_chunk = min(kv_chunk, sk)
    pad = (-sk) % kv_chunk
    if pad:
        # zero-pad the key tail; padded positions are masked below via k_pos
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    valid_k = sk
    n_chunks = (sk + pad) // kv_chunk
    scale = 1.0 / float(d) ** 0.5

    qf = q.float()
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        k_c = _repeat_kv(k[:, sl], n_rep).float()
        v_c = _repeat_kv(v[:, sl], n_rep).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c) * scale
        if logit_cap is not None:
            s = logit_cap * torch.tanh(s / logit_cap)
        k_pos = c * kv_chunk + torch.arange(kv_chunk, device=q.device)
        ok = (k_pos < valid_k)[None, :].expand(sq, kv_chunk)
        if causal:
            ok = ok & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
        s = s + torch.where(ok, 0.0, NEG_INF)[None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_c)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)   # (B, Sq, Hq, D)


def attention_chunked_backward(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
) -> tuple:
    """(dq, dk, dv): the vjp of :func:`attention_chunked` for the cotangent
    ``dout``, written out (a custom op's body runs below autograd) in f32
    over the materialized scores, the results in the inputs' dtype.  With
    P = softmax(S): dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(P dP)),
    times the soft-cap's 1 - tanh^2 and the scale, dQ = dS K, dK = dS^T Q;
    dK and dV are summed over each GQA group's query heads."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    n_rep = hq // hkv
    scale = 1.0 / float(d) ** 0.5
    qf, do = q.float(), dout.float()
    kf, vf = _repeat_kv(k, n_rep).float(), _repeat_kv(v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if logit_cap is not None:
        t = torch.tanh(s / logit_cap)
        s = logit_cap * t
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    p = torch.softmax(s + _mask_bias(q_pos, k_pos, causal, window)[None, None], dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    if logit_cap is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dk = dk.reshape(b, sk, hkv, n_rep, d).sum(dim=3)
    dv = dv.reshape(b, sk, hkv, n_rep, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_backward_bf16_products(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
) -> tuple:
    """:func:`attention_chunked_backward` with the roundings of the bf16
    kernel (flash_attention_backward.cu's mma route): P and dS rounded to
    bf16 before the products they enter (dV = P^T dO, dQ = dS K,
    dK = dS^T Q), delta taken as dO . O from the forward's output ``out``,
    and rows that see no key given zero gradients."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    n_rep = hq // hkv
    scale = 1.0 / float(d) ** 0.5
    qf, do = q.float(), dout.float()
    kf, vf = _repeat_kv(k, n_rep).float(), _repeat_kv(v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    slope = torch.full_like(s, scale)
    if logit_cap is not None:
        t = torch.tanh(s / logit_cap)
        s, slope = logit_cap * t, (1.0 - t * t) * scale
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    seen = _mask_bias(q_pos, k_pos, causal, window) == 0.0
    p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1).nan_to_num(0.0)
    delta = (do * out.float()).sum(-1).transpose(1, 2)[..., None]    # (b, hq, sq, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = p * (dp - delta) * slope
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, do)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, qf)
    dk = dk.reshape(b, sk, hkv, n_rep, d).sum(dim=3)
    dv = dv.reshape(b, sk, hkv, n_rep, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
