"""Flash attention as one custom op: the Hopper kernel on a CUDA tensor, the
chunked plain version on a CPU tensor.  Registered as
``repro_torch::flash_attention`` so a traced graph keeps it as one node."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import library
from repro_torch.kernels.flash_attention.ref import (
    attention_chunked,
    attention_chunked_backward,
    attention_dense,
)

HEAD_DIMS = (32, 64, 96, 128, 256)
TILE_ROWS = 64   # packed (query, head) rows per block of the wgmma route
TILE_KEYS = 64   # keys per K/V tile of the wgmma route


def packed_row(p: int, n_rep: int) -> Tuple[int, int]:
    """(query, head within the GQA group) of packed row p of the wgmma
    route: the n_rep heads of one KV head are neighbouring rows."""
    return divmod(p, n_rep)


def tile_plan(b: int, sq: int, hq: int, hkv: int, dtype: torch.dtype,
              d: Optional[int] = None) -> Dict[str, object]:
    """The grid the kernel launches for these shapes, as its C entry point
    computes it.  bf16 takes the tensor cores (wgmma): one block per 64
    packed rows of one (KV head, batch row), grid (ceil(Sq n_rep / 64),
    Hkv, B).  f32 takes the CUDA cores (wgmma multiplies f32 only as TF32,
    short of the f32 tolerance): one block per 16 queries of one (batch row,
    query head), grid (ceil(Sq / 16), B Hq).  With the head dim ``d`` the
    plan also gives the tile rows' width in shared memory and the dynamic
    shared memory in bytes: the wgmma route pads a row to whole 64-column
    atoms of the 128-byte swizzle (32 -> 64, 96 -> 128) and keeps Q, two
    stages of K and V and one P atom (+ 1 KB to align the base); the CUDA
    cores stage 32 keys of K and V in f32."""
    n_rep = hq // hkv
    if dtype == torch.bfloat16:
        rows = sq * n_rep
        plan = dict(route="wgmma", rows=rows, grid=(-(-rows // TILE_ROWS), hkv, b))
    elif dtype == torch.float32:
        plan = dict(route="cuda_cores", rows=sq, grid=(-(-sq // 16), b * hq))
    else:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    if d is None:
        return plan
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if plan["route"] == "wgmma":
        atoms = -(-d // 64)
        return dict(plan, width=64 * atoms, smem=(5 * atoms + 1) * 64 * 128 + 1024)
    return dict(plan, width=d, smem=2 * 32 * d * 4)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    window: Optional[int],
    logit_cap: Optional[float],
    q_offset: int,
) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    bk, sk, hkv, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if not all(t.is_contiguous() and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash attention takes contiguous tensors on one device")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    dtype = library.dtype_code(q.dtype)
    plan = tile_plan(b, sq, hq, hkv, q.dtype, d)
    if plan["route"] == "wgmma":
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the wgmma route copies 16-byte vectors: q, k, v must be "
                             "16-byte aligned")
        if max(plan["grid"][1:]) > 65535:
            raise ValueError(f"grid {plan['grid']} over the launch limit")
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    fn = library.entry("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    library.LAUNCHES["flash_attention"] += 1
    library.check("flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, hq, hkv, d, int(causal),
        0 if window is None else int(window),
        0.0 if logit_cap is None else float(logit_cap),
        int(q_offset), dtype, stream,
    ))
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    window: Optional[int],
    logit_cap: Optional[float],
    q_offset: int,
) -> torch.Tensor:
    if q.device.type == "cpu":
        # contiguous, as the fake output says: a traced graph views it
        return attention_chunked(
            q, k, v, causal=causal, window=window, logit_cap=logit_cap,
            q_offset=q_offset,
        ).contiguous()
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal, window, logit_cap, q_offset)
    raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {q.device}")


@flash_attention_op.register_fake
def _(q, k, v, causal, window, logit_cap, q_offset):
    return torch.empty_like(q)


def _flash_attention_vmap(info, in_dims, q, k, v, causal, window, logit_cap, q_offset):
    """Batching rule: the grid is per batch row, so the lanes fold into the
    batch axis of one launch (an unbatched operand is expanded and then
    written out once per lane, ``library.fold_lanes``)."""
    ops = [library.lanes_first(t, d, info.batch_size) for t, d in zip((q, k, v), in_dims)]
    lanes, b = ops[0].shape[:2]
    out = flash_attention_op(*(library.fold_lanes(t) for t in ops), causal, window, logit_cap,
                             q_offset)
    return out.reshape(lanes, b, *out.shape[1:]), 0


torch.library.register_vmap(flash_attention_op, _flash_attention_vmap)

BWD_HEAD_DIMS = (32, 64, 96, 128)
BWD_TILE = 64   # rows a block owns and rows a streamed tile holds, on both routes


def backward_plan(b: int, sq: int, sk: int, hq: int, hkv: int, d: int,
                  dtype: torch.dtype) -> Dict[str, object]:
    """The backward's two launches, as its C entry point makes them, from
    the shapes and the dtype alone: the dq pass (which also writes each
    query row's logsumexp and dO . O) and then the dk/dv pass, each with its
    grid and dynamic shared memory in bytes.

    bf16 takes the tensor cores (``route="mma"``, mma.sync): the dq pass
    has one block of 4 warps per 64 packed (query, head) rows of one (KV
    head, batch row) (:func:`packed_row`), the dk/dv pass one block of 8
    warps per 64 keys of one (KV head, batch row), two groups of 4 warps
    taking alternate (head, query tile) iterations.  Both grids are (Hkv, B,
    tiles) with the tile index slowest, so the blocks that see the most
    work under the causal mask are dispatched first (the dq pass counts its
    tiles from the last).  The dq pass keeps six bf16 tiles of 64 rows
    padded by 16 bytes (Q and dO resident, a two-stage ring of K and V),
    the dk/dv pass ten (K and V resident, a two-stage ring of Q and dO per
    group) and two stages of the query rows' f32 logsumexp and delta per
    group.  f32 takes the CUDA cores (``route="cuda_cores"``, 256 threads a
    block): grids (ceil(Sq / 64), Hq, B) and (ceil(Sk / 64), Hkv, B), four
    f32 tiles of 64 rows padded by one float, and one or two 64 x 64 f32
    tiles of dS / P."""
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash attention backward takes head dims {BWD_HEAD_DIMS}, not {d}")
    kv_tiles = -(-sk // BWD_TILE)
    if dtype == torch.bfloat16:
        tile = BWD_TILE * (d + 8) * 2
        return dict(route="mma", threads_dq=128, threads_dkv=256,
                    grid_dq=(hkv, b, -(-(sq * (hq // hkv)) // BWD_TILE)),
                    grid_dkv=(hkv, b, kv_tiles), smem_dq=6 * tile,
                    smem_dkv=10 * tile + 2 * 4 * BWD_TILE * 4)
    if dtype == torch.float32:
        tiles = 4 * BWD_TILE * (d + 1) * 4
        tile = BWD_TILE * (BWD_TILE + 1) * 4
        return dict(route="cuda_cores", threads_dq=256, threads_dkv=256,
                    grid_dq=(-(-sq // BWD_TILE), hq, b), grid_dkv=(kv_tiles, hkv, b),
                    smem_dq=tiles + tile, smem_dkv=tiles + 2 * tile)
    raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")


def flash_attention_backward_cuda(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    causal: bool,
    window: Optional[int],
    logit_cap: Optional[float],
    q_offset: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels; raises on anything they do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    bk, sk, hkv, dk_ = k.shape
    if bk != b or dk_ != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)}, out {tuple(out.shape)} vs q {tuple(q.shape)}")
    if not all(t.dtype == q.dtype for t in (k, v, out, dout)):
        raise TypeError("q, k, v, out and dout must share one dtype")
    ts = (dout, q, k, v, out)
    if not all(t.is_contiguous() and t.device == q.device for t in ts):
        raise ValueError("flash attention backward takes contiguous tensors on one device")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash attention backward copies 16-byte vectors: 16-byte aligned "
                         "tensors")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    plan = backward_plan(b, sq, sk, hq, hkv, d, q.dtype)
    if max(plan["grid_dq"][1:] + plan["grid_dkv"][1:]) > 65535:
        raise ValueError(f"grids {plan['grid_dq']}, {plan['grid_dkv']} over the launch limit")
    dtype = library.dtype_code(q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # each query row's logsumexp and dO . O, written by the dq pass
    stats = torch.empty((2, b, hq, sq), dtype=torch.float32, device=q.device)
    fn = library.entry("flash_attention_backward")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    library.LAUNCHES["flash_attention_backward"] += 1
    library.check("flash_attention_backward", fn(
        dout.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        b, sq, sk, hq, hkv, d, int(causal),
        0 if window is None else int(window),
        0.0 if logit_cap is None else float(logit_cap),
        int(q_offset), dtype, stream,
    ))
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def flash_attention_backward_op(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    causal: bool,
    window: Optional[int],
    logit_cap: Optional[float],
    q_offset: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        grads = attention_chunked_backward(dout, q, k, v, causal=causal, window=window,
                                           logit_cap=logit_cap, q_offset=q_offset)
        return tuple(g.contiguous() for g in grads)
    if q.device.type == "cuda":
        return flash_attention_backward_cuda(dout, q, k, v, out, causal, window, logit_cap,
                                             q_offset)
    raise ValueError(f"flash_attention_backward runs on cpu or cuda tensors, not {q.device}")


@flash_attention_backward_op.register_fake
def _(dout, q, k, v, out, causal, window, logit_cap, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window, logit_cap, q_offset = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.args = (causal, window, logit_cap, q_offset)


def _flash_grad(ctx, dout):
    q, k, v, out = ctx.saved_tensors
    dq, dk, dv = flash_attention_backward_op(dout.contiguous(), q, k, v, out, *ctx.args)
    return dq, dk, dv, None, None, None, None


torch.library.register_autograd(flash_attention_op, _flash_grad, setup_context=_flash_setup)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Fused attention: q (B,Sq,Hq,D) × kv (B,Sk,Hkv,D) -> (B,Sq,Hq,D)."""
    return flash_attention_op(q, k, v, causal, window, logit_cap, q_offset)


__all__ = [
    "flash_attention", "flash_attention_cuda", "attention_chunked", "attention_dense",
    "packed_row", "tile_plan", "attention_chunked_backward", "backward_plan",
    "flash_attention_backward_cuda", "flash_attention_backward_op",
]
