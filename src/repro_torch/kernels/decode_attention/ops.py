"""Decode attention as one custom op: the Hopper kernel on a CUDA tensor,
the plain version on a CPU tensor.  Registered as
``repro_torch::decode_attention`` so a traced graph keeps it as one node."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import library
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    decode_attention_split_ref,
)

HEAD_DIMS = (32, 64, 128, 256)
MAX_REP = 8     # query heads per KV head the kernel serves from one K/V read
# keys per split (one block per (KV head, batch row, split)); the served
# caches (S = 512, 128) are one split, a 16k cache 32
SPLIT_LEN = 512


def split_plan(s: int, split_len: int = SPLIT_LEN) -> Tuple[int, int]:
    """(split length L, n_split) of the kernel's grid for a cache of S
    positions: n_split = ceil(S / L), from the cache length alone.  kv_len
    is a device tensor: reading it here would sync, and a captured replay
    graph fixes the grid when it is captured."""
    if s <= 0 or split_len <= 0:
        raise ValueError(f"cache length {s}, split length {split_len}")
    return split_len, -(-s // split_len)


def decode_attention_cuda(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    window: Optional[int],
    split_len: int = SPLIT_LEN,
) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take.  With
    more than one split, the f32 scratch of the splits' partial softmax
    states, (B, Hq, n_split, D + 2), is allocated here; a second kernel
    merges it."""
    b, hq, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"k/v cache shapes {tuple(k_cache.shape)} {tuple(v_cache.shape)}"
        )
    _, s, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs cache {tuple(k_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if hq % hkv or hq // hkv > MAX_REP:
        raise ValueError(f"Hq={hq}, Hkv={hkv}: need Hkv | Hq and Hq/Hkv <= {MAX_REP}")
    if not (k_cache.dtype == v_cache.dtype == q.dtype):
        raise TypeError(f"q {q.dtype}, k {k_cache.dtype}, v {v_cache.dtype}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,):
        raise TypeError(f"kv_len must be int32 of shape ({b},)")
    tensors = (q, k_cache, v_cache, kv_len)
    if not all(t.is_contiguous() and t.device == q.device for t in tensors):
        raise ValueError("decode attention takes contiguous tensors on one device")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode attention loads 16-byte vectors: q, k, v must be 16-byte aligned")
    dtype = library.dtype_code(q.dtype)
    split_len, n_split = split_plan(s, split_len)
    out = torch.empty_like(q)
    if b == 0:
        return out
    part = (torch.empty((b, hq, n_split, d + 2), dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    fn = library.entry("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    library.LAUNCHES["decode_attention"] += 1
    library.check("decode_attention", fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, hq, hkv, s, d,
        0 if window is None else int(window), split_len, dtype, stream,
    ))
    return out


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention_op(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    window: Optional[int],
) -> torch.Tensor:
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len, window=window)
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, kv_len, window)
    raise ValueError(f"decode_attention runs on cpu or cuda tensors, not {q.device}")


@decode_attention_op.register_fake
def _(q, k_cache, v_cache, kv_len, window):
    return torch.empty_like(q)


def _decode_attention_vmap(info, in_dims, q, k_cache, v_cache, kv_len, window):
    """Batching rule: every (KV head, batch row) is its own block, so the
    lanes fold into the batch axis of one launch — B becomes lanes·B, and
    ``kv_len`` a (lanes·B,) vector.  An unbatched operand is expanded and
    then written out once per lane (``library.fold_lanes``)."""
    ops = [library.lanes_first(t, d, info.batch_size)
           for t, d in zip((q, k_cache, v_cache, kv_len), in_dims)]
    lanes, b = ops[0].shape[:2]
    out = decode_attention_op(*(library.fold_lanes(t) for t in ops), window)
    return out.reshape(lanes, b, *out.shape[1:]), 0


torch.library.register_vmap(decode_attention_op, _decode_attention_vmap)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q (B,Hq,D) × cache (B,S,Hkv,D), valid lengths (B,) int32 -> (B,Hq,D)."""
    return decode_attention_op(q, k_cache, v_cache, kv_len, window)


__all__ = [
    "decode_attention", "decode_attention_ref", "decode_attention_split_ref",
    "decode_attention_cuda", "split_plan",
]
